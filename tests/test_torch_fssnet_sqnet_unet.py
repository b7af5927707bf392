"""The port's FSSNet, SQNet and UNet and their blocks against the JAX
reference, on the CPU (helpers and their conventions:
``tests/_torch_parity.py``).

None of the three reaches a kernel: FSSNet and SQNet end in a transposed
conv, UNet in a 1x1 conv, and each predict is the argmax of the full
logits. UNet's logits and step are held at ``base=8`` (its width scales
with ``base``; the code path is the same), its base-64 parameter count
from the reference's ``jax.eval_shape``.
"""
from functools import partial

import jax
import numpy as np
import pytest
import torch

from esn_tpu import nn as jnn
from esn_tpu.models import fssnet as JF
from esn_tpu.models import sqnet as JS
from esn_tpu.models import unet as JU

from esn_tpu_torch import convert
from esn_tpu_torch.models import available_models, build_model
from esn_tpu_torch.models import fssnet as F
from esn_tpu_torch.models import sqnet as S
from esn_tpu_torch.models import unet as U
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
N_PARAMS = {"fssnet": 167_802, "sqnet": 6_402_035, "unet": 31_038_803}
# the models as the tests below build them: UNet at base 8
KW = {"fssnet": {}, "sqnet": {}, "unet": {"base": 8}}
# Logits against the reference's, f32: atol = rtol = LOGIT_TOL[arch]; f64
# atol = rtol = 1e-8. Readings, the largest difference relative to
# max(1, |logit|), port f32 vs reference f32 / reference f32 vs its f64 /
# port f64 vs reference f64: FSSNet 1.4e-5 / 1.0e-5 / 3.8e-14, SQNet
# 2.2e-6 / 1.5e-6 / 3.0e-15, UNet (base 8) 1.8e-5 / 2.0e-5 / 5.0e-14.
LOGIT_TOL = {"fssnet": 1e-4, "sqnet": 1e-4, "unet": 1e-4}
# The f32 step's per-leaf gradient against the f64 oracle: rel-L2 within
# GRAD_F32 plus the shared ABS. Readings, the worst leaf (median): FSSNet
# 7.5e-6 (5.0e-6), SQNet 3.5e-4 (4.3e-6; f3, the fire module after the
# second max pool), UNet 7.8e-6 (4.8e-6); the leaves whose gradient is
# 0 in exact arithmetic read noise up to 3.1e-7 (SQNet's f2/e1 bias). All
# three are well-conditioned in f32, unlike the BN-heavy residual stacks.
# The f64 run reads 4.3e-6 at most (the loss stays f32).
GRAD_F32 = {"fssnet": 1e-4, "sqnet": 3e-3, "unet": 1e-4}


# --- blocks ------------------------------------------------------------------

BLOCKS = {
    "initial": (lambda: JF.InitialBlock(3, 16), lambda: F.InitialBlock(3, 16),
                3),
    "down_pad": (lambda: JF.DownBottleneck(16, 64, 0.0),
                 lambda: F.DownBottleneck(16, 64, 0.0), 16),
    "down_same": (lambda: JF.DownBottleneck(16, 16, 0.0),
                  lambda: F.DownBottleneck(16, 16, 0.0), 16),
    "factorized": (lambda: JF.FactorizedBlock(16, 0.0),
                   lambda: F.FactorizedBlock(16, 0.0), 16),
    "dilated": (lambda: JF.DilatedBlock(16, 5, 0.0),
                lambda: F.DilatedBlock(16, 5, 0.0), 16),
    "up": (lambda: JF.UpBottleneck(16, 8, 0.0),
           lambda: F.UpBottleneck(16, 8, 0.0), 16),
    "fire": (lambda: JS.Fire(16, 4, 8), lambda: S.Fire(16, 4, 8), 16),
    "parallel_dilated": (lambda: JS.ParallelDilatedConv(8, 6),
                         lambda: S.ParallelDilatedConv(8, 6), 8),
    "double_conv": (lambda: JU.DoubleConv(4, 8), lambda: U.DoubleConv(4, 8),
                    4),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_reference(kind, train):
    """Each block on converted weights (FSSNet's upsampling transposed
    conv flipped by ``convert``), eval and train mode (dropout 0): the
    output and the updated BN statistics (atol = rtol = 1e-5)."""
    make_j, make_t, ch = BLOCKS[kind]
    check_block(make_j(), make_t(), ch, train)


TWO_INPUT = {
    "bypass_refine": (lambda: JS.BypassRefine(8, 6, 4),
                      lambda: S.BypassRefine(8, 6, 4), 8, 6),
    "up_deconv": (lambda: JU.Up(8, 4, bilinear=False),
                  lambda: U.Up(8, 4, bilinear=False), 8, 4),
    "up_bilinear": (lambda: JU.Up(8, 4, bilinear=True),
                    lambda: U.Up(8, 4, bilinear=True), 8, 4),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", sorted(TWO_INPUT))
def test_two_input_block_matches_reference(kind, train):
    """SQNet's bypass refinement and UNet's up stages (transposed conv or
    bilinear, then ``concat([skip, x])``) on a deep input at half the
    skip's size: the output (atol = rtol = 1e-5)."""
    make_j, make_t, deep_ch, skip_ch = TWO_INPUT[kind]
    rng = np.random.RandomState(6)
    deep = rng.randn(2, deep_ch, 5, 7).astype(np.float32)
    skip = rng.randn(2, skip_ch, 10, 14).astype(np.float32)
    jblock, block = make_j(), make_t()
    variables = random_variables(
        init_shapes(jblock, nhwc(deep), nhwc(skip)), rng)
    block.load_state_dict(convert.to_state_dict(variables, block),
                          strict=True)
    want = jnn.apply(jblock, variables, nhwc(deep), nhwc(skip), train=train,
                     mutable=train)
    if train:
        want = want[0]
    block.train(train)
    with torch.no_grad():
        got = block(torch.from_numpy(deep), torch.from_numpy(skip))
    np.testing.assert_allclose(got.numpy(), nchw(want), atol=1e-5, rtol=1e-5)


# --- the models --------------------------------------------------------------

@pytest.fixture(scope="module", params=["fssnet", "sqnet", "unet"])
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def reference(arch):
    return reference_shapes(arch, HW, **KW[arch])


@pytest.fixture(scope="module")
def pair(arch, reference):
    jmodel, shapes = reference
    variables, model = calibrated_pair(arch, shapes, HW, **KW[arch])
    return jmodel, variables, model


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).randn(2, 3, *HW).astype(np.float32)


def test_registry_and_param_count(arch):
    """Registered as in the reference; its parameter count at full width
    (UNet base 64: from the reference's ``jax.eval_shape``, no forward),
    its conv tail and its dropout rates."""
    assert arch in available_models()
    _, shapes = reference_shapes(arch, (32, 64))
    n = sum(int(np.prod(v.shape))
            for v in jax.tree_util.tree_leaves(shapes["params"]))
    model = build_model(arch.upper(), CLASSES, device="cpu")
    assert count_params(model) == N_PARAMS[arch] == n
    assert model.LOGITS_TAIL == "conv"
    rates = sorted({m.rate for m in model.modules()
                    if hasattr(m, "rate")})
    assert rates == {"fssnet": [0.03, 0.1], "sqnet": [],
                     "unet": []}[arch]


def test_unet_options():
    """UNet's ``base`` and ``bilinear`` options: parameter counts equal the
    reference's at base 8 with transposed convs and with bilinear ups."""
    for kw in ({"base": 8}, {"base": 8, "bilinear": True}):
        _, shapes = reference_shapes("unet", (32, 64), **kw)
        n = sum(int(np.prod(v.shape))
                for v in jax.tree_util.tree_leaves(shapes["params"]))
        assert count_params(build_model("unet", CLASSES, device="cpu",
                                        **kw)) == n


def test_convert_round_trip_is_bit_exact(arch, reference):
    """reference tree -> state_dict -> port model -> state_dict -> tree;
    the keys are the reference's variable paths (FSSNet's ``init`` block
    and scanned chains, SQNet's ``d{i}``, UNet's ``down{i}``/``up{i}``);
    the transposed convs' kernels flipped on the way in and back."""
    variables = random_variables(reference[1], np.random.RandomState(7))
    model = build_model(arch, CLASSES, device="cpu", **KW[arch])
    sd = round_trip(variables, model)
    keys = {"fssnet": ("init.post.1.weight", "dil.1.2.core.conv.weight",
                       "up2.up.weight", "dec1.1.mid_post.0.running_var",
                       "head.weight"),
            "sqnet": ("context.d3.weight", "f8.e3.bias", "r1.up.weight",
                      "r3.fuse.weight", "head.bias"),
            "unet": ("down3.c2.bn.running_mean", "up0.up.weight",
                     "up3.conv.c1.conv.weight", "head.bias")}[arch]
    for key in keys:
        assert key in sd
    head = {"fssnet": "head", "sqnet": "head", "unet": None}[arch]
    up = {"fssnet": ("up2", "up"), "sqnet": ("r1", "up"),
          "unet": ("up0", "up")}[arch]
    p = variables["params"]
    for name, k in ((f"{up[0]}.{up[1]}", p[up[0]][up[1]]["kernel"]),
                    *(((head, p[head]["kernel"]),) if head else ())):
        np.testing.assert_array_equal(sd[name + ".weight"].numpy(),
                                      k[::-1, ::-1].transpose(2, 3, 0, 1))


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_logits_match_reference(pair, images, dtype):
    """Logits at 2x3x64x128 on converted, calibrated weights: f32 within
    LOGIT_TOL, f64 within 1e-8."""
    jmodel, variables, model = pair
    arch = type(model).__name__.lower()
    tol = LOGIT_TOL[arch] if dtype == np.float32 else 1e-8
    want = reference_logits(jmodel, variables, images, dtype)
    got = port_logits(model, images, dtype)
    assert got.shape == want.shape
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_predict_step_matches_reference(pair, images):
    """The port's predict against the reference's (FSSNet and SQNet: the
    fused subpixel head; UNet: the argmax of the full logits)."""
    jmodel, variables, model = pair
    check_predict(jmodel, variables, model, images,
                  2 * LOGIT_TOL[type(model).__name__.lower()])


def test_paths_take_no_kernel(arch, images, monkeypatch):
    """A predict calls ``subpixel_argmax`` once (FSSNet's and SQNet's
    fused head) or no kernel wrapper (UNet); a weighted-CE train step
    calls none."""
    calls = []
    for name in ("fused_dsconv", "resize_argmax", "resize_ce_sums",
                 "fused_cgblock_pre", "subpixel_argmax"):
        monkeypatch.setattr(K, name, partial(
            lambda name, real, *a, **k: calls.append(name) or real(*a, **k),
            name, getattr(K, name)))
    model = build_model(arch, CLASSES, device="cpu", **KW[arch])
    make_predict_step(model)(torch.from_numpy(images))
    assert calls == ([] if arch == "unet" else ["subpixel_argmax"])
    calls.clear()
    assert L.fused_resize_ce_spec(model, "ce") == (None, None)
    step = make_train_step(model, partial(L.cross_entropy,
                                          num_classes=CLASSES),
                           O.build_optimizer("adam", model.parameters()),
                           generator=torch.Generator().manual_seed(0))
    step({"image": torch.from_numpy(images),
          "label": torch.zeros((2, *HW), dtype=torch.int32)})
    assert calls == []


def test_train_step_matches_reference(arch):
    """One adam + poly step (class-weighted CE on the full logits) on
    converted weights against the reference's math in f64: the loss,
    per-leaf gradients (f32 within GRAD_F32), the BN statistics and the
    parameters after the step."""
    check_step(step_readings(arch, HW, GRAD_F32[arch], **KW[arch]))
