"""A predict step built before a train step and called after it.

``TrainStep`` puts the model in train mode on every step. The reference
passes ``train=False`` on every predict call, so the port's predict step
puts the model back in eval mode on every call: it normalises with the BN
running statistics, leaves them as they are, and takes the fused eval
paths (``DSConv`` -> ``fused_dsconv``, ``CGBlock`` -> ``fused_cgblock_pre``;
on the CPU both run their plain versions, so the fused path is seen by the
calls made, not by ``LAUNCHES``).
"""
from functools import partial

import numpy as np
import pytest
import torch

from esn_tpu_torch.models import build_model
from esn_tpu_torch.models.blocks import DSConv
from esn_tpu_torch.models.cgnet import CGBlock
from esn_tpu_torch.ops import kernels as K
from esn_tpu_torch.train import losses as L
from esn_tpu_torch.train.optimizers import build_optimizer
from esn_tpu_torch.train.step import (make_eval_step, make_predict_step,
                                      make_train_step)

CLASSES = 19
# the wrapper that each model's eval path calls, and the blocks that call it
FUSED = {"fastscnn": ("fused_dsconv", DSConv, {}),
         "cgnet": ("fused_cgblock_pre", CGBlock, {"m": 2, "n": 3})}


def _batch(seed, hw=(64, 128)):
    rng = np.random.RandomState(seed)
    images = torch.from_numpy(rng.randn(2, 3, *hw).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, CLASSES, (2, *hw))
                              .astype(np.int32))
    return images, labels


def _train_step(model):
    fused, method = L.fused_resize_ce_spec(model, "ce")
    fused = fused or L.cross_entropy       # a conv-tail model: plain CE
    return make_train_step(
        model, partial(fused, num_classes=CLASSES),
        build_optimizer("adam", model.parameters()), fwd_method=method,
        generator=torch.Generator().manual_seed(1))


@pytest.fixture
def count_calls(monkeypatch):
    """{wrapper name: calls} of the kernels' wrappers, as the models look
    them up (in ``esn_tpu_torch.ops.kernels`` at call time)."""
    calls = {}
    for name in ("fused_dsconv", "fused_cgblock_pre"):
        calls[name] = 0

        def counted(*args, _fn=getattr(K, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(K, name, counted)
    return calls


@pytest.mark.parametrize("arch", sorted(FUSED))
def test_predict_after_a_train_step_runs_in_eval_mode(arch, count_calls):
    wrapper, block, kw = FUSED[arch]
    model = build_model(arch, CLASSES, device="cpu",
                        generator=torch.Generator().manual_seed(0), **kw)
    images, labels = _batch(0)
    predict = make_predict_step(model)            # built before the step
    step = _train_step(model)
    step({"image": images, "label": labels})
    assert model.training and count_calls[wrapper] == 0   # composed paths

    stats = {name: buf.clone() for name, buf in model.named_buffers()}
    probe = _batch(1)[0]
    got = predict(probe)
    assert not model.training
    assert all(not m.training for m in model.modules())
    blocks = sum(isinstance(m, block) for m in model.modules())
    assert blocks > 0 and count_calls[wrapper] == blocks  # the fused paths
    for name, buf in model.named_buffers():               # BN stats stay
        assert torch.equal(buf, stats[name]), name

    # the same as a predict of the model put in eval mode by hand
    model.eval()
    with torch.inference_mode():
        want = model.predict(probe.contiguous(
            memory_format=torch.channels_last))
    assert got.dtype == torch.int32 and torch.equal(got, want)

    # and again after another step, with an output size
    sized = make_predict_step(model, output_size=(48, 100))
    step({"image": images, "label": labels})
    assert model.training
    out = sized(probe)
    assert not model.training and tuple(out.shape) == (2, 48, 100)

    # one submodule alone in train mode (the root's flag does not show it)
    want = predict(probe)
    next(model.children()).train()
    assert not model.training
    assert torch.equal(predict(probe), want)
    assert all(not m.training for m in model.modules())


@pytest.mark.parametrize("arch", ["cgnet", "enet", "fastscnn"])
def test_eval_step_after_a_train_step_runs_in_eval_mode(arch):
    """An eval step built before a train step and called after it: eval
    mode in every module, the buffers untouched, and the class map and
    confusion matrix of the model put in eval mode by hand."""
    kw = FUSED.get(arch, (None, None, {}))[2]
    model = build_model(arch, CLASSES, device="cpu",
                        generator=torch.Generator().manual_seed(0), **kw)
    images, labels = _batch(0)
    evaluate = make_eval_step(model, CLASSES)     # built before the step
    step = _train_step(model)
    step({"image": images, "label": labels})
    assert model.training

    stats = {name: buf.clone() for name, buf in model.named_buffers()}
    probe, probe_labels = _batch(1)
    pred, cm = evaluate({"image": probe, "label": probe_labels})
    assert all(not m.training for m in model.modules())
    for name, buf in model.named_buffers():
        assert torch.equal(buf, stats[name]), name
    model.eval()
    with torch.inference_mode():
        want = model.predict(probe.contiguous(
            memory_format=torch.channels_last))
    assert pred.dtype == torch.int32 and torch.equal(pred, want)
    assert int(cm.sum()) == probe_labels.numel()
    assert int(torch.diagonal(cm).sum()) == int((want == probe_labels).sum())
