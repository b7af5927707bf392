"""The port's span layer (``esn_tpu_torch.utils.profiling.span``) on the
CPU: nothing recorded while no profiler runs; under ``torch.profiler`` a
train step's and a predict's spans, their order, parents and call ids,
the BatchNorm spans (once each under a checkpoint's recompute), the
bounded buffer and the launching thread."""
import collections
import threading
from functools import partial

import pytest
import torch

from esn_tpu_torch.models import build_model
from esn_tpu_torch.nn import BatchNorm
from esn_tpu_torch.train import losses as L
from esn_tpu_torch.train import optimizers as O
from esn_tpu_torch.train import schedules as S
from esn_tpu_torch.train.step import make_predict_step, make_train_step
from esn_tpu_torch.utils import profiling

CLASSES = 19
BATCH, HW = 2, (128, 256)
TRAIN_CHILDREN = ["train.prepare", "train.forward", "train.loss",
                  "train.backward", "train.optimizer"]
PREDICT_CHILDREN = ["predict.prepare", "predict.forward", "predict.tail"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def recorded(fn, *args):
    """``fn(*args)`` under a CPU ``torch.profiler`` session, into an empty
    span buffer: (its result, the spans it recorded, BatchNorm forwards
    counted by hooks)."""
    bn_calls = [0]

    def count(module, inputs):
        bn_calls[0] += isinstance(module, BatchNorm)
    hook = torch.nn.modules.module.register_module_forward_pre_hook(count)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(profiling, "_records", collections.deque(
                maxlen=profiling.SPAN_CAPACITY))
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                out = fn(*args)
            return out, profiling.spans(), bn_calls[0]
    finally:
        hook.remove()


def _images(seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((BATCH, 3, *HW), generator=g)


def _fastscnn_train(remat):
    model = build_model("fastscnn", CLASSES, device="cpu")
    fused, method = L.fused_resize_ce_spec(model, "ce")
    opt = O.build_optimizer("adam", model.parameters())
    step = make_train_step(model, partial(fused, num_classes=CLASSES), opt,
                           schedule=S.build_schedule("poly", 1e-3, 100),
                           fwd_method=method,
                           generator=torch.Generator().manual_seed(3),
                           remat=remat)
    g = torch.Generator().manual_seed(4)
    batch = {"image": _images(1),
             "label": torch.randint(0, CLASSES, (BATCH, *HW), generator=g)}
    step(batch)                 # the first call's lazy set-up, untraced
    _, spans, bn_calls = recorded(step, batch)
    return spans, bn_calls


@pytest.fixture(scope="module")
def fastscnn_train():
    return _fastscnn_train(remat=False)


@pytest.fixture(scope="module")
def cgnet_predict():
    model = build_model("cgnet", CLASSES, device="cpu")
    predict = make_predict_step(model)
    x = _images(2)
    predict(x)
    pred, spans, bn_calls = recorded(predict, x)
    assert pred.shape == (BATCH, *HW)
    return spans, bn_calls


def _root(spans, name):
    roots = [s for s in spans if s.name == name]
    assert len(roots) == 1, [s.name for s in spans]
    return roots[0]


def _children(spans, root):
    return sorted((s for s in spans if s.parent == root.id),
                  key=lambda s: s.start_ns)


def test_span_is_off_without_a_profiler(monkeypatch):
    """No profiler: the span is the shared null context, makes no record
    and enters no ``record_function``, and a train step or a predict
    records nothing."""
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=8))
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("train.step") is profiling._OFF
    with profiling.span("train.step"):
        pass
    model = build_model("fastscnn", CLASSES, device="cpu")
    make_predict_step(model)(_images(5))
    assert entered == [] and profiling.spans() == []


def test_train_step_records_its_five_children_in_order(fastscnn_train):
    spans, _ = fastscnn_train
    root = _root(spans, "train.step")
    kids = _children(spans, root)
    assert [s.name for s in kids] == TRAIN_CHILDREN
    assert root.parent is None and root.call == root.id
    assert {s.call for s in spans} == {root.id}
    for a, b in zip(kids, kids[1:]):
        assert root.start_ns <= a.start_ns <= a.end_ns <= b.start_ns \
            <= b.end_ns <= root.end_ns
    forward = kids[1]
    bns = [s for s in spans if s.name == "bn"]
    assert bns and all(forward.start_ns <= s.start_ns <= s.end_ns
                       <= forward.end_ns for s in bns)
    assert all(s.device_ms is None for s in spans)     # no CUDA here


def test_train_step_children_cover_the_root(fastscnn_train):
    spans, _ = fastscnn_train
    root = _root(spans, "train.step")
    covered = sum(s.end_ns - s.start_ns for s in _children(spans, root))
    assert covered >= 0.99 * (root.end_ns - root.start_ns)


def test_predict_records_prepare_forward_tail(cgnet_predict):
    spans, _ = cgnet_predict
    root = _root(spans, "predict.step")
    assert [s.name for s in _children(spans, root)] == PREDICT_CHILDREN
    assert {s.call for s in spans} == {root.id}


@pytest.mark.parametrize("which", ["fastscnn_train", "cgnet_predict"])
def test_one_bn_span_per_batchnorm_forward(which, request):
    spans, bn_calls = request.getfixturevalue(which)
    assert bn_calls > 0
    assert sum(s.name == "bn" for s in spans) == bn_calls


def test_recompute_records_each_bn_forward_once(fastscnn_train):
    """Under ``remat`` the backward runs every BatchNorm's forward again
    (the hooks count both runs); the recompute opens no span, so the
    step records the same spans as without it."""
    spans, bn_calls = _fastscnn_train(remat=True)
    plain, plain_calls = fastscnn_train
    assert bn_calls == 2 * plain_calls
    assert sorted(s.name for s in spans) == sorted(s.name for s in plain)


def test_span_inside_a_backward_is_off(monkeypatch):
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=8))

    class Spanned(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return 2 * x

        @staticmethod
        def backward(ctx, g):
            with profiling.span("inside"):
                return 2 * g
    x = torch.ones(3, requires_grad=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("outside"):
            Spanned.apply(x).sum().backward()
    assert [s.name for s in profiling.spans()] == ["outside"]
    assert x.grad.tolist() == [2.0, 2.0, 2.0]


def test_buffer_is_bounded_and_counts_drops(monkeypatch):
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=4))
    monkeypatch.setattr(profiling, "_dropped", 0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(10):
            with profiling.span(f"s{i}"):
                pass
    assert [s.name for s in profiling.spans()] == ["s6", "s7", "s8", "s9"]
    assert profiling.spans_dropped() == 6


def test_span_on_another_thread_carries_its_id(monkeypatch):
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=8))
    ident = []

    def work():
        ident.append(threading.get_ident())
        with profiling.span("worker"):
            pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("main"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=60)
    assert not t.is_alive()
    got = {s.name: s for s in profiling.spans()}
    assert got["worker"].thread == ident[0] != got["main"].thread
    assert got["main"].thread == threading.get_ident()
    # the worker's stack is its own: no parent across threads
    assert got["worker"].parent is None
    assert got["worker"].call == got["worker"].id


def test_device_time_from_events_at_the_edges(monkeypatch):
    """With a CUDA context the span records a timing event at each edge
    on the stream current at its opening, and ``spans`` gives the time
    between them (fake events stand in for the card's)."""
    class FakeEvent:
        clock = [0.0]

        def __init__(self, enable_timing=False):
            assert enable_timing
            self.at = self.stream = None

        def record(self, stream):
            FakeEvent.clock[0] += 2.5
            self.at, self.stream = FakeEvent.clock[0], stream

        def synchronize(self):
            assert self.at is not None

        def elapsed_time(self, end):
            return end.at - self.at
    streams = iter(["s0", "s1"])
    made = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: next(streams))
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: made.append(
        FakeEvent(**kw)) or made[-1])
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=8))
    with profiling.span("off"):
        pass
    assert made == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
    got = {s.name: s for s in profiling.spans()}
    assert set(got) == {"outer", "inner"}
    assert got["inner"].device_ms == 2.5 and got["outer"].device_ms == 7.5
    assert [e.stream for e in made] == ["s0", "s0", "s1", "s1"]
