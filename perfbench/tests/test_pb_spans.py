"""The readers of the program's spans (``prepare_idle_ms``, ``forward_ms``,
``backward_ms``, ``bn_fwd_ms``) on a synthetic trace and synthetic span
records, and on the card the spans' clock against the trace's.

    python -m pytest perfbench/tests/test_pb_spans.py -q [-m cuda]
"""
from __future__ import annotations

import time

import pytest

from perfbench import bench, spans as S
from perfbench.drivers import common
from perfbench.tests.conftest import small_cell
from perfbench.yardstick.trace import Trace
from esn_tpu_torch.utils import profiling

MS = 1e-3
NS = 1_000_000          # ns a ms


def span(name, a_ms, b_ms, device_ms=None, sid=0):
    return profiling.Span(sid, name, int(a_ms * NS), int(b_ms * NS), 1,
                          None, 1, device_ms)


def one_call_trace(calls=1, early_ms=0.0):
    """Train calls on the benchmark's clock, in ms, one each 30: pick 0-1,
    entry 1-10, sync 10-30; the device runs 4-20 and 21-30, so it idles
    0-4 (from the pick into the entry) and 20-21 (in sync). The device's
    operations stamped ``early_ms`` before the host's clock."""
    ops, spans = [], []
    for i in range(calls):
        at = 30 * i
        ops += [("conv", (at + 4 - early_ms) * MS, (at + 20 - early_ms) * MS),
                ("adam", (at + 21 - early_ms) * MS, (at + 30 - early_ms) * MS)]
        spans += [("pick", at * MS, (at + 1) * MS),
                  ("entry", (at + 1) * MS, (at + 10) * MS),
                  ("sync", (at + 10) * MS, (at + 30) * MS)]
    return Trace(ops, spans)


def readings(trace, route="train"):
    window = common.Window(1.0, 10, [0.1] * 10, [0.05] * 10)
    return common.Readings(route=route, window=window, flops_per_call=1,
                           kernels=[], trace=trace, launches_per_call={})


def read(metric, r):
    reader, part = bench.metric_reader(metric)
    return reader.read(r, part)


@pytest.fixture
def recorded(monkeypatch):
    """Plant the program's span records."""
    def plant(rows):
        monkeypatch.setattr(profiling, "spans", lambda: list(rows))
    return plant


def test_gap_in_prepare_counts(recorded):
    """The opening gap (0-4 ms) counts for the 1.9 ms the host spends in
    ``train.prepare`` (1.1-3.0), whatever lies on either side."""
    recorded([span("train.step", 1, 10), span("train.prepare", 1.1, 3.0),
              span("train.forward", 3.0, 6.0, 12.5)])
    r = readings(one_call_trace())
    assert read("prepare_idle_ms.train", r) == pytest.approx(1.9)
    assert S.idle_by_span(r.trace, S.program_spans(r.trace)) == \
        pytest.approx({"pick": 1 * MS, "train.step": 0.1 * MS,
                       "train.prepare": 1.9 * MS, "train.forward": 1 * MS,
                       "sync": 1 * MS})


def test_gap_in_forward_does_not_count(recorded):
    """The card runs the prepare's cast (1.1-1.5 ms) and idles from there
    to 4 ms inside ``train.forward``: no idle lies in the prepare."""
    recorded([span("train.step", 1, 10), span("train.prepare", 1.1, 1.5),
              span("train.forward", 1.5, 6.0, 12.5)])
    t = one_call_trace()
    r = readings(Trace(t.ops + [("cast", 1.1 * MS, 1.5 * MS)], t.spans))
    assert read("prepare_idle_ms.train", r) == 0.0
    assert S.idle_by_span(r.trace, S.program_spans(r.trace)) == \
        pytest.approx({"pick": 1 * MS, "train.step": 0.1 * MS,
                       "train.forward": 2.5 * MS, "sync": 1 * MS})


def test_spans_outside_the_stretch_are_ignored(recorded):
    recorded([span("train.forward", 3.0, 6.0, 12.5),
              span("train.backward", 6.0, 9.0, 20.0),
              span("bn", 3.5, 4.0, 1.25), span("bn", 4.0, 4.5, 0.75),
              # a span of another stretch: 1 s on, and one crossing the end
              span("train.forward", 1000, 1003, 99.0),
              span("bn", 29.0, 31.0, 99.0),
              span("train.prepare", 1000, 1002)])
    r = readings(one_call_trace())
    # the events' ms less the idle while the host was inside: forward
    # 12.5 - 1 (3-4 ms), the BNs 1.25 - 0.5 (3.5-4) + 0.75
    assert read("forward_ms.train", r) == pytest.approx(11.5)
    assert read("backward_ms.train", r) == pytest.approx(20.0)
    assert read("bn_fwd_ms.train", r) == pytest.approx(1.5)
    assert read("prepare_idle_ms.train", r) is None
    assert read("forward_ms.predict", r) is None       # another route


def test_device_ms_takes_off_the_idle_inside_each_call(recorded):
    """Two calls: each ``train.forward``'s events hold the card's idle
    while the host was in it (1 ms, then 0.5 ms), which the reader takes
    off before it divides by the calls."""
    recorded([span("train.forward", 3.0, 6.0, 12.5),
              span("train.forward", 33.5, 36.0, 11.0)])
    assert read("forward_ms.train", readings(one_call_trace(2))) == \
        pytest.approx((12.5 - 1.0 + 11.0 - 0.5) / 2)


@pytest.mark.parametrize("early_ms", [0.0, 1.5, -0.8])
def test_device_clock_is_moved_onto_the_hosts(recorded, early_ms):
    """Device timestamps off the host's clock by a constant read as on
    it: each call's last operation is moved to its sync's end."""
    recorded([span("train.step", 1, 10), span("train.prepare", 1.1, 3.0),
              span("train.forward", 3.0, 6.0, 12.5),
              span("train.step", 31, 40), span("train.prepare", 31.1, 33.0),
              span("train.forward", 33.0, 36.0, 12.5)])
    r = readings(one_call_trace(2, early_ms))
    assert read("prepare_idle_ms.train", r) == pytest.approx(1.9)
    assert read("forward_ms.train", r) == pytest.approx(11.5)
    assert S.idle_by_span(r.trace, S.program_spans(r.trace)) == \
        pytest.approx({"pick": 2 * MS, "train.step": 0.2 * MS,
                       "train.prepare": 3.8 * MS, "train.forward": 2 * MS,
                       "sync": 2 * MS})


def test_clock_shift_follows_a_drift_between_syncs():
    """Stamped 0.5 ms early at the first sync and 1.5 ms at the second:
    the shift is held before the first, interpolated between them and
    held after the last."""
    t = one_call_trace(2)
    early = {0: 0.5, 1: 1.5}
    ops = [(n, a - early[a > 30 * MS] * MS, b - early[a > 30 * MS] * MS)
           for n, a, b in t.ops]
    shift = S.clock_shift(Trace(ops, t.spans))
    assert shift(2 * MS) == pytest.approx(0.5 * MS)
    assert shift(29.5 * MS) == pytest.approx(0.5 * MS)
    assert shift(44.0 * MS) == pytest.approx(1.0 * MS)
    assert shift(58.5 * MS) == pytest.approx(1.5 * MS)
    assert shift(70.0 * MS) == pytest.approx(1.5 * MS)
    assert S.clock_shift(Trace(ops, [])) (5 * MS) == 0.0


def test_dropped_spans_in_the_stretch_give_none(recorded, monkeypatch):
    """The program's buffer dropped spans: where the oldest it kept closed
    inside the stretch, what the stretch recorded may be cut, and the
    readers give None; where it closed before, the stretch is whole."""
    monkeypatch.setattr(profiling, "spans_dropped", lambda: 3)
    rows = [span("train.forward", 3.0, 6.0, 12.5)]
    recorded(rows)
    r = readings(one_call_trace())
    assert read("forward_ms.train", r) is None
    recorded([span("train.forward", -9.0, -8.0, 1.0)] + rows)
    assert read("forward_ms.train", r) == pytest.approx(11.5)


@pytest.mark.parametrize("metric", ["prepare_idle_ms.train",
                                    "forward_ms.train", "backward_ms.train",
                                    "bn_fwd_ms.train"])
@pytest.mark.parametrize("program", ["no span", "no span layer"])
def test_reader_returns_none_with_no_span(metric, program, recorded,
                                          monkeypatch):
    if program == "no span":
        recorded([])
    else:                   # a tree older than the span layer
        monkeypatch.delattr(profiling, "spans")
    assert read(metric, readings(one_call_trace())) is None
    assert read(metric, readings(None)) is None


def first_ops_before_their_span(prof, spans, name, shift=lambda t: 0.0):
    """Of the ``name`` spans, those that hold a launch whose device
    operation starts before the span opened on the shared clock (span id,
    ns before the span, ns before the launch), and how many hold a launch
    at all: a launch is matched to its device operation by the CUDA
    correlation id of the trace. ``shift`` moves a device timestamp (s)
    onto the host's clock (``perfbench.spans.clock_shift``)."""
    from torch.autograd import DeviceType
    launch_ns, op_ns = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        if e.device_type() == DeviceType.CUDA:
            corr = e.correlation_id() or e.linked_correlation_id()
            at = e.start_ns() + round(1e9 * shift(e.start_ns() * 1e-9))
            op_ns[corr] = min(op_ns.get(corr, at), at)
        elif e.correlation_id():
            launch_ns[e.correlation_id()] = e.start_ns()
    early, held = [], 0
    for s in spans:
        if s.name != name:
            continue
        starts = [(op_ns[c], t) for c, t in launch_ns.items()
                  if c in op_ns and s.start_ns <= t <= s.end_ns]
        if starts:
            held += 1
            first, launched = min(starts)
            if first < s.start_ns:
                early.append((s.id, s.start_ns - first, launched - first))
    return early, held


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fastscnn-train-b16",
                                  "fastscnn-predict-b32"])
def test_forward_spans_precede_their_device_operations(card, name,
                                                       monkeypatch):
    """A traced run of each route at a small size: the first device
    operation launched inside each ``*.forward`` span starts after the
    span opened, on the host's clock (the program's counterpart of
    ``Trace.clock_check``): 0 such spans. The profiler's device
    timestamps drift from the host's clock, at times past a launch of
    their own, so they are first moved onto it as the readers move them
    (``perfbench.spans.aligned``); how many spans the raw stamps put
    early is printed."""
    import torch
    profiles = []
    real = Trace.from_profiler.__func__

    def keep(cls, prof, spans):
        profiles.append(prof)
        return real(cls, prof, spans)
    monkeypatch.setattr(Trace, "from_profiler", classmethod(keep))
    cell = small_cell(name, "bfloat16")
    opened = time.time_ns()
    res = bench.driver_module(cell.route).run(
        cell, 2**31 + 41, 0.5, True, card, time.perf_counter(),
        lambda msg: None)
    assert res["readings"].trace.ops and len(profiles) == 1
    recorded = [s for s in profiling.spans() if s.start_ns >= opened]
    forward = f"{cell.route}.forward"
    raw, _ = first_ops_before_their_span(profiles[0], recorded, forward)
    early, held = first_ops_before_their_span(
        profiles[0], recorded, forward,
        S.clock_shift(res["readings"].trace))
    print(f"{name}: {len(raw)} early on the profiler's own stamps {raw}")
    assert held >= cell.traffic["traced_steps" if cell.route == "train"
                                else "traced_calls"]
    assert early == []
    torch.cuda.empty_cache()
