"""The port's FPENet and its blocks against the JAX reference, on the CPU
(helpers and their conventions: ``tests/_torch_parity.py``).

FPENet's ``LOGITS_TAIL`` is ``"resize"``, but it has no ``logits_lowres``:
its head sits at 1/2 resolution under an f32 bilinear x2. So its predict
is the argmax of the full logits (the reference's too, with its fused x2
head + argmax off) and its CE runs on the full logits
(``fused_resize_ce_spec`` gives ``(None, None)``): no kernel lies on its
path. Its depthwise convs run at dilations 1, 2, 4 and 8, the case of
torch's CPU bf16 defect that ``ops.convolution.conv2d`` works around
(tests/test_torch_conv_bf16_dw.py).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esn_tpu import nn as jnn
from esn_tpu.models import blocks as JB
from esn_tpu.models import fpenet as JF
from esn_tpu.ops import pooling as JP
from esn_tpu.ops import resize as JR

from esn_tpu_torch import convert
from esn_tpu_torch.models import available_models, build_model
from esn_tpu_torch.models import blocks as B
from esn_tpu_torch.models import fpenet as FP
from esn_tpu_torch.ops import kernels as K
from esn_tpu_torch.train import losses as L
from esn_tpu_torch.train import optimizers as O
from esn_tpu_torch.train.step import make_predict_step, make_train_step
from esn_tpu_torch.utils import count_params

from _torch_parity import (CLASSES, calibrated_pair, check_block,
                           check_predict, check_step, init_shapes, nchw,
                           nhwc, one_torch_thread, plain_reference,
                           port_logits, random_variables, reference_logits,
                           reference_shapes, round_trip, step_readings)

assert one_torch_thread and plain_reference     # autouse fixtures
HW = (64, 128)
N_PARAMS = 358_194


def _meu_in_dtype(self, scope, deep, shallow):
    """The reference's MEU with its channel mean in x's dtype (it takes
    it in f32 whatever the input), for the f64 runs."""
    d = scope("deep_conv", self.deep_conv, deep)
    s = scope("shallow_conv", self.shallow_conv, shallow)
    ca = jnn.sigmoid(scope("chan_fc", self.chan_fc, JP.global_avg_pool(d)))
    sa = jnp.mean(s, axis=-1, keepdims=True)
    sa = jnn.sigmoid(scope("spat_conv", self.spat_conv, sa))
    d_up = JR.resize_bilinear(d, s.shape[1:3])
    return jnn.relu(d_up * sa + s * ca)


PATCHES = ((JF.MEU, "__call__", _meu_in_dtype),)
# Logits against the reference's, f32: atol = rtol = LOGIT_TOL. Read, the
# largest difference relative to max(1, |logit|): the port's full logits
# lie 3.6e-5 from the reference's f32 ones (its 1/2-res features 4.4e-5),
# which lie 3.2e-5 (6.3e-5) from its own f64 ones. f64, the features
# (both packages upsample the logits in f32): atol = rtol = 1e-8 (read
# 8.4e-14).
LOGIT_TOL = 1e-4
# The f32 step's per-leaf gradient against the f64 oracle: rel-L2 within
# GRAD_F32 plus GRAD_ABS_F32. Read: 9.8e-2 at worst, stage1's SE fc1 (a
# gate of 16 channels has one hidden unit), 5.6e-3 median: train-mode BN
# over 4-channel groups at a batch of 2 makes the f32 gradient
# ill-conditioned. An SE gate whose hidden unit is dead has gradient 0 in
# exact arithmetic behind it: its f32 reading is noise, up to 8.6e-6
# (stage3/2's fc2). The f64 run reads 4.5e-6 at most.
GRAD_F32, GRAD_ABS_F32 = 0.2, 2e-5


# --- blocks ------------------------------------------------------------------

BLOCKS = {
    "fpe_t1": (lambda: JF.FPEBlock(8, 8, t=1), lambda: FP.FPEBlock(8, 8, t=1),
               8),
    "fpe_t4": (lambda: JF.FPEBlock(16, 16, t=4),
               lambda: FP.FPEBlock(16, 16, t=4), 16),
    "fpe_down": (lambda: JF.FPEBlock(16, 32, stride=2, t=4),
                 lambda: FP.FPEBlock(16, 32, stride=2, t=4), 16),
    "se": (lambda: JB.SEGate(32, 16), lambda: B.SEGate(32, 16), 32),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_reference(kind, train):
    """Each block on converted weights, eval and train mode: the output
    and the updated BN statistics (atol = rtol = 1e-5); the stride-2
    block at an odd size."""
    make_j, make_t, ch = BLOCKS[kind]
    check_block(make_j(), make_t(), ch, train,
                hw=(13, 17) if kind == "fpe_down" else (12, 16))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_meu_matches_reference(train):
    """MEU on a deep 1/8 and a shallow 1/4 input: the output and, in
    train mode, the BN statistics (atol = rtol = 1e-5)."""
    rng = np.random.RandomState(6)
    deep = rng.randn(2, 16, 6, 8).astype(np.float32)
    shallow = rng.randn(2, 8, 12, 16).astype(np.float32) + 0.5
    jblock, block = JF.MEU(16, 8, 8), FP.MEU(16, 8, 8)
    variables = random_variables(
        init_shapes(jblock, nhwc(deep), nhwc(shallow)), rng)
    block.load_state_dict(convert.to_state_dict(variables, block),
                          strict=True)
    want = jnn.apply(jblock, variables, nhwc(deep), nhwc(shallow),
                     train=train, mutable=train)
    if train:
        want = want[0]
    block.train(train)
    with torch.no_grad():
        got = block(torch.from_numpy(deep), torch.from_numpy(shallow))
    np.testing.assert_allclose(got.numpy(), nchw(want), atol=1e-5, rtol=1e-5)


# --- the model, full width and depth ----------------------------------------

@pytest.fixture(scope="module")
def reference():
    return reference_shapes("fpenet", HW)


@pytest.fixture(scope="module")
def pair(reference):
    jmodel, shapes = reference
    variables, model = calibrated_pair("fpenet", shapes, HW)
    return jmodel, variables, model


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).randn(2, 3, *HW).astype(np.float32)


def test_registry_and_param_count(reference):
    """Registered as in the reference; its parameter count and tail."""
    assert "fpenet" in available_models()
    model = build_model("FPENet", CLASSES, device="cpu")
    n = sum(int(np.prod(v.shape))
            for v in jax.tree_util.tree_leaves(reference[1]["params"]))
    assert count_params(model) == N_PARAMS == n
    assert model.LOGITS_TAIL == "resize"
    assert not hasattr(model, "logits_lowres")
    assert L.fused_resize_ce_spec(model, "ce") == (None, None)


def test_convert_round_trip_is_bit_exact(reference):
    """reference tree -> state_dict -> port model -> state_dict -> tree;
    the keys are the reference's variable paths (the depthwise convs
    ``dw{i}``, the SE gate's ``fc1``/``fc2`` kernels transposed, the
    scanned stages as Sequentials)."""
    variables = random_variables(reference[1], np.random.RandomState(7))
    model = build_model("fpenet", CLASSES, device="cpu")
    sd = round_trip(variables, model)
    for key in ("stage3.7.dw3.conv.weight", "stage2.1.se.fc1.weight",
                "down3.expand.bn.running_var", "meu1.spat_conv.bias",
                "meu2.chan_fc.weight", "head.bias", "stem.conv.weight"):
        assert key in sd
    fc = variables["params"]["stage1"]["se"]["fc2"]["kernel"]
    np.testing.assert_array_equal(sd["stage1.se.fc2.weight"].numpy(), fc.T)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_logits_match_reference(pair, images, dtype):
    """The full logits (f32) and the 1/2-res features under the head (f32
    and f64) at 2x3x64x128 on converted, calibrated weights: f32 within
    LOGIT_TOL, f64 within 1e-8."""
    jmodel, variables, model = pair
    tol = LOGIT_TOL if dtype == np.float32 else 1e-8
    methods = [None, "features"] if dtype == np.float32 else ["features"]
    for method in methods:
        want = reference_logits(jmodel, variables, images, dtype, method,
                                PATCHES)
        got = port_logits(model, images, dtype, method)
        assert got.shape == want.shape
        assert want.std() > 0.05
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_predict_step_matches_reference(pair, images):
    """The port's predict (the 1x1 head at 1/2, then the fused x2
    upsample + argmax) against the reference's (its fused x2 head)."""
    jmodel, variables, model = pair
    check_predict(jmodel, variables, model, images, 2 * LOGIT_TOL)


def test_paths_take_no_kernel(images, monkeypatch):
    """A predict calls one kernel wrapper, ``resize_argmax`` at r = 2 on
    the 1/2-resolution logits (its fused x2 head); a weighted-CE train
    step calls none: the CE runs on the full logits."""
    calls = []
    for name in ("fused_dsconv", "resize_argmax", "resize_ce_sums",
                 "fused_cgblock_pre", "subpixel_argmax"):
        monkeypatch.setattr(K, name, partial(
            lambda name, real, *a, **k: calls.append(name) or real(*a, **k),
            name, getattr(K, name)))
    model = build_model("fpenet", CLASSES, device="cpu")
    make_predict_step(model)(torch.from_numpy(images))
    assert calls == ["resize_argmax"]
    calls.clear()
    step = make_train_step(model, partial(L.cross_entropy,
                                          num_classes=CLASSES),
                           O.build_optimizer("adam", model.parameters()))
    step({"image": torch.from_numpy(images),
          "label": torch.zeros((2, *HW), dtype=torch.int32)})
    assert calls == []


def test_train_step_matches_reference():
    """One adam + poly step (class-weighted CE on the full logits) on
    converted weights against the reference's math in f64: the loss,
    per-leaf gradients (f32 within GRAD_F32), the BN statistics and the
    parameters after the step."""
    r = step_readings("fpenet", HW, GRAD_F32, GRAD_ABS_F32, patches=PATCHES)
    assert r["method"] is None
    check_step(r)
