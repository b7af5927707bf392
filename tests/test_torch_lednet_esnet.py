"""The port's LEDNet and ESNet and their blocks against the JAX reference,
on the CPU (helpers and their conventions: ``tests/_torch_parity.py``).

LEDNet ends in the bilinear resize tail: its predict ends in the fused
upsample + argmax (one ``resize_argmax`` call at r = 8) and its CE trains
through ``logits_lowres`` (one ``resize_ce_sums`` call); the kernels'
plain versions here, since a CPU tensor never reaches a CUDA kernel.
ESNet ends in a transposed conv and launches no kernel.
"""
from functools import partial

import jax
import numpy as np
import pytest
import torch

from esn_tpu.models import blocks as JB
from esn_tpu.models import esnet as JS
from esn_tpu.models import lednet as JL

from esn_tpu_torch.models import available_models, build_model
from esn_tpu_torch.models import blocks as B
from esn_tpu_torch.models import esnet as S
from esn_tpu_torch.models import lednet as LN
from esn_tpu_torch.nn import Dropout
from esn_tpu_torch.ops import kernels as K
from esn_tpu_torch.train import losses as L
from esn_tpu_torch.train import optimizers as O
from esn_tpu_torch.train.step import make_predict_step, make_train_step
from esn_tpu_torch.utils import count_params

from _torch_parity import (CLASSES, calibrated_pair, check_block,
                           check_predict, check_step, nhwc, one_torch_thread,
                           plain_reference, port_logits, random_variables,
                           reference_logits, reference_shapes, round_trip,
                           step_readings)

assert one_torch_thread and plain_reference     # autouse fixtures
HW = (64, 128)
N_PARAMS = {"lednet": 1_074_703, "esnet": 1_660_607}
# Logits against the reference's, f32: atol = rtol = LOGIT_TOL[arch]. Read,
# the largest difference relative to max(1, |logit|): the port's f32
# logits lie 5.6e-4 (LEDNet; 6.3e-4 its 1/8 logits) and 3.5e-4 (ESNet)
# from the reference's f32 ones, which lie 2.4e-4 (2.6e-4) and 2.7e-4
# from its own f64 logits (the residual stacks amplify rounding, as in
# ERFNet). f64 (LEDNet's 1/8 logits only: both packages upsample in f32):
# atol = rtol = 1e-8 (read 6.9e-13 and 6.5e-13).
LOGIT_TOL = {"lednet": 2e-3, "esnet": 1e-3}
# The f32 step's per-leaf gradient against the f64 oracle: rel-L2 within
# GRAD_F32 plus GRAD_ABS_F32 (read, the worst leaf whose gradient is not 0
# in exact arithmetic: LEDNet 4.8e-2, encoder/7's l3 bias: its d=17 convs
# see mostly padding at 1/8 of 64x128; ESNet 2.5e-2; median 1.5e-2 and
# 1.3e-2: train-mode BN over a batch of 2 makes the f32 gradient
# ill-conditioned, as ERFNet's). A conv bias under a train-mode BN has
# gradient 0: its f32 reading is noise, up to 4.1e-5 (LEDNet's stem) and
# 1.4e-6 (ESNet's). The f64 run reads 4.7e-6 and 4.2e-6 (median).
GRAD_F32 = {"lednet": 0.1, "esnet": 5e-2}
GRAD_ABS_F32 = {"lednet": 1e-4, "esnet": 3e-6}


# --- blocks ------------------------------------------------------------------

BLOCKS = {
    "ssnbt": (lambda: JL.SSnbt(8, 1), lambda: LN.SSnbt(8, 1), 8),
    "ssnbt_d5": (lambda: JL.SSnbt(8, 5), lambda: LN.SSnbt(8, 5), 8),
    "apn": (lambda: JL.APN(16, 5), lambda: LN.APN(16, 5), 16),
    "lednet_down": (lambda: JB.DownsamplerConcat(3, 32, bn_eps=1e-3),
                    lambda: B.DownsamplerConcat(3, 32, bn_eps=1e-3), 3),
    "pfcu": (lambda: JS.PFCU(8, dropout=0.0), lambda: S.PFCU(8, dropout=0.0),
             8),
    "fcu_k5": (lambda: JB.NonBottleneck1d(8, k=5),
               lambda: B.NonBottleneck1d(8, k=5), 8),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_reference(kind, train):
    """Each block on converted weights, eval and train mode (dropout 0):
    the output and the updated BN statistics (atol = rtol = 1e-5). APN at
    32x64 (its cascade reaches 1/8 of its input)."""
    make_j, make_t, ch = BLOCKS[kind]
    check_block(make_j(), make_t(), ch, train,
                hw=(32, 64) if kind == "apn" else (12, 16))


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("c, groups", [(8, 2), (12, 3), (64, 2)])
def test_channel_shuffle_and_split(c, groups, channels_last):
    """``channel_shuffle``: output channel ``j * g + i`` is input channel
    ``i * (C // g) + j``, as the reference's NHWC reshape-transpose (equal
    bit for bit); the output is channels_last. ``channel_split``: the two
    halves."""
    from esn_tpu.models.blocks import channel_shuffle as jshuffle
    x = np.random.RandomState(0).randn(2, c, 5, 7).astype(np.float32)
    t = torch.from_numpy(x)
    if channels_last:
        t = t.contiguous(memory_format=torch.channels_last)
    got = B.channel_shuffle(t, groups)
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = np.asarray(jshuffle(nhwc(x), groups)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    left, right = B.channel_split(t)
    np.testing.assert_array_equal(left.numpy(), x[:, :c // 2])
    np.testing.assert_array_equal(right.numpy(), x[:, c // 2:])
    with pytest.raises(ValueError):
        B.channel_shuffle(t, 5)


# --- the two models, full width and depth ------------------------------------

@pytest.fixture(scope="module", params=["lednet", "esnet"])
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def reference(arch):
    return reference_shapes(arch, HW)


@pytest.fixture(scope="module")
def pair(arch, reference):
    jmodel, shapes = reference
    variables, model = calibrated_pair(arch, shapes, HW)
    return jmodel, variables, model


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).randn(2, 3, *HW).astype(np.float32)


def test_registry_and_param_count(arch, reference):
    """Registered as in the reference; its parameter count, tail and
    dropout rates."""
    assert arch in available_models()
    model = build_model(arch.upper(), CLASSES, device="cpu")
    params = reference[1]["params"]
    n = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(params))
    assert count_params(model) == N_PARAMS[arch] == n
    rates = sorted({m.rate for m in model.modules() if isinstance(m, Dropout)})
    if arch == "lednet":
        assert model.LOGITS_TAIL == "resize" and rates == [0.03, 0.3]
    else:
        assert model.LOGITS_TAIL == "conv" and rates == [0.0, 0.03, 0.3]


def test_convert_round_trip_is_bit_exact(arch, reference):
    """reference tree -> state_dict -> port model -> state_dict -> tree;
    the keys are the reference's variable paths (scan chains as
    Sequentials; PFCU's branches ``b{i}_*``); ESNet's transposed convs'
    kernels flipped on the way in and back."""
    variables = random_variables(reference[1], np.random.RandomState(7))
    model = build_model(arch, CLASSES, device="cpu")
    sd = round_trip(variables, model)
    keys = {"lednet": ("encoder.1.2.r4.weight", "encoder.6.1.2.l_bn2.bias",
                       "encoder.7.l3.weight", "apn.down3.bn.running_var",
                       "apn.glob.conv.bias", "encoder.4.post.bn.weight"),
            "esnet": ("encoder.5.2.b2_bn.running_mean",
                      "encoder.5.0.b1_2.weight", "encoder.3.1.p2b.weight",
                      "decoder.2.deconv.weight", "head.weight")}[arch]
    for key in keys:
        assert key in sd
    if arch == "esnet":
        k = variables["params"]["head"]["kernel"]
        np.testing.assert_array_equal(sd["head.weight"].numpy(),
                                      k[::-1, ::-1].transpose(2, 3, 0, 1))


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_logits_match_reference(pair, images, dtype):
    """Logits at 2x3x64x128 on converted, calibrated weights (LEDNet's 1/8
    logits too): f32 within LOGIT_TOL, f64 within 1e-8 (LEDNet's 1/8
    logits only: both packages upsample in f32)."""
    jmodel, variables, model = pair
    arch = type(model).__name__.lower()
    tol = LOGIT_TOL[arch] if dtype == np.float32 else 1e-8
    methods = [None] if model.LOGITS_TAIL == "conv" else (
        ["logits_lowres"] if dtype == np.float64 else [None, "logits_lowres"])
    for method in methods:
        want = reference_logits(jmodel, variables, images, dtype, method)
        got = port_logits(model, images, dtype, method)
        assert got.shape == want.shape
        assert want.std() > 0.05      # the weights make non-trivial logits
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_predict_step_matches_reference(pair, images):
    """The port's predict (LEDNet: the fused upsample + argmax; ESNet: the
    fused subpixel head) against the reference's (the same)."""
    jmodel, variables, model = pair
    check_predict(jmodel, variables, model, images,
                  2 * LOGIT_TOL[type(model).__name__.lower()])


def test_paths_take_the_kernels(arch, images, monkeypatch):
    """The routes the card's launch counts confirm, seen here through the
    wrappers' calls: a LEDNet predict calls ``resize_argmax`` once on the
    1/8 logits at r = 8 and a weighted-CE train step ``resize_ce_sums``
    once; an ESNet predict calls ``subpixel_argmax`` once on the 16
    channels under its head (stride 2), its train step none."""
    calls = []

    def spy(name):
        real = getattr(K, name)

        def wrapper(*args, **kw):
            calls.append((name, tuple(args[0].shape),
                          kw.get("r") or kw.get("stride") or args[1]))
            return real(*args, **kw)
        monkeypatch.setattr(K, name, wrapper)
    for name in ("fused_dsconv", "resize_argmax", "resize_ce_sums",
                 "fused_cgblock_pre", "subpixel_argmax"):
        spy(name)
    model = build_model(arch, CLASSES, device="cpu")
    make_predict_step(model)(torch.from_numpy(images))
    low = (2, HW[0] // 8, HW[1] // 8, CLASSES)
    lednet = arch == "lednet"
    assert calls == ([("resize_argmax", low, 8)] if lednet else
                     [("subpixel_argmax", (2, HW[0] // 2, HW[1] // 2, 16),
                       (2, 2))])
    calls.clear()
    fused, method = L.fused_resize_ce_spec(model, "ce")
    assert method == ("logits_lowres" if lednet else None)
    step = make_train_step(model, partial(fused or L.cross_entropy,
                                          num_classes=CLASSES),
                           O.build_optimizer("adam", model.parameters()),
                           fwd_method=method,
                           generator=torch.Generator().manual_seed(0))
    step({"image": torch.from_numpy(images),
          "label": torch.zeros((2, *HW), dtype=torch.int32)})
    assert calls == ([("resize_ce_sums", low, 8)] if lednet else [])


def test_train_step_matches_reference(arch):
    """One adam + poly step (class-weighted CE; LEDNet through
    ``logits_lowres``) on converted weights against the reference's math
    in f64: the loss, per-leaf gradients (f32 within GRAD_F32), the BN
    statistics and the parameters after the step."""
    check_step(step_readings(arch, HW, GRAD_F32[arch], GRAD_ABS_F32[arch]))
