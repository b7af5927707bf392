"""The port's fused prediction heads against the reference's
(``esn_tpu/ops/classify.py`` ``subpixel_argmax`` and
``resize2x_head_argmax``, ``esn_tpu/models/blocks.py``
``subpixel_predict_tail``), on seeded numpy inputs: the subpixel phase
conv and depth-to-space, the class argmax of both geometries of the zoo's
heads (k2s2p0, k3s2p1op1) in f32 and bf16, FPENet's x2 head, and every
model that predicts through a head, whose predict must never build the
full-resolution logits. K7's plain version runs here (a CPU tensor); the
kernel's own tables (``kernels.subpixel_argmax._pack_weights``,
``_descriptor``) are held through a numpy emulation of its loop. Torch
runs on one intra-op thread.
"""
import importlib
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from esn_tpu.ops import classify as JCL
from esn_tpu.ops import convolution as JC
from esn_tpu.ops.resize import resize_bilinear as jax_resize_bilinear

from esn_tpu_torch import nn as enn
from esn_tpu_torch.models import build_model
from esn_tpu_torch.ops import classify as CL
from esn_tpu_torch.ops import convolution as C
from esn_tpu_torch.ops import kernels as K
from esn_tpu_torch.ops import resize as R
from esn_tpu_torch.train.step import make_predict_step

from _torch_parity import (calibrated_pair, check_predict,  # noqa: F401
                           one_torch_thread, reference_shapes)

# the kernel's module (``kernels.subpixel_argmax`` is its wrapper)
SA = importlib.import_module("esn_tpu_torch.ops.kernels.subpixel_argmax")
# (kernel, padding, output_padding) of the zoo's two head geometries
GEOMETRIES = {"k2s2p0": (2, 0, 0), "k3s2p1op1": (3, 1, 1)}
# odd H and W: the last row's and column's phase-1 taps (k3s2p1op1) reach
# past the edge
XSHAPE = (2, 37, 53)
HW = (64, 128)
# the eight models whose predict goes through a head, with twice their
# files' f32 logit tolerance as the near-tie gap of check_predict
# (tests/test_torch_enet.py, _erfnet_edanet.py, _lednet_esnet.py,
# _espnet.py, _fssnet_sqnet_unet.py, _segnet_linknet.py, _fpenet.py)
HEAD_MODELS = {"enet": 1e-4, "erfnet": 2e-3, "esnet": 1e-3, "espnet": 1e-4,
               "fssnet": 1e-4, "linknet": 1e-4, "sqnet": 1e-4,
               "fpenet": 1e-4}
# the reference's plain paths (its own fused predict stays on)
PLAIN_ENV = ("ESN_TPU_FOLD", "ESN_TPU_FPE_FOLDED", "ESN_TPU_FOLD_DW",
             "ESN_TPU_S2D_CONV", "ESN_TPU_S2D_STEM", "ESN_TPU_SCAN_CHAIN",
             "ESN_TPU_ESP_FOLD_REDUCE", "ESN_TPU_ESPNET_PIECES")


@pytest.fixture(autouse=True)
def plain_reference(monkeypatch):
    for name in PLAIN_ENV:
        monkeypatch.setenv(name, "0")
    monkeypatch.delenv("ESN_TPU_FUSED_PREDICT", raising=False)
    monkeypatch.delenv("ESN_TPU_ESP_FUSED_HFF", raising=False)


def _case(seed, cin, cout, k, bias, hw=XSHAPE):
    """x (N, H, W, I), the port's weight (I, O, k, k) and the reference's
    kernel of it (HWIO, both spatial axes flipped, as convert does), bias
    or None; numpy f32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*hw, cin).astype(np.float32)
    w = (rng.randn(cin, cout, k, k) / np.sqrt(cin * k)).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32) if bias else None
    return x, w, w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1).copy(), b


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_subpixel_phase_conv_and_depth_to_space_match_reference(geometry):
    """f32 within 1e-5: the phase-major logits (the port's taps in torch's
    unflipped convention against the reference's in its flipped one) and
    their depth-to-space."""
    k, p, _ = GEOMETRIES[geometry]
    x, w, wj, _ = _case(0, 16, 19, k, False)
    got = C.subpixel_phase_conv(_t(x), _t(w), stride=(2, 2), padding=(p, p))
    want = JC.subpixel_phase_conv(_j(x), _j(wj), stride=(2, 2),
                                  padding=(p, p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(
        C.depth_to_space(got, 2, 2).numpy(),
        np.asarray(JC.depth_to_space(want, 2, 2)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("hw", [(2, 8, 12), XSHAPE])
def test_depth_to_space_of_phases_is_the_transposed_conv(geometry, hw):
    """``depth_to_space(subpixel_phase_conv(x, w)) + b`` equals
    ``F.conv_transpose2d`` in f32 within 1e-5."""
    k, p, op = GEOMETRIES[geometry]
    x, w, _, b = _case(1, 16, 11, k, True, hw)
    got = C.depth_to_space(C.subpixel_phase_conv(
        _t(x), _t(w), stride=(2, 2), padding=(p, p)), 2, 2) + _t(b)
    want = F.conv_transpose2d(_t(x).permute(0, 3, 1, 2), _t(w), _t(b),
                              stride=2, padding=p, output_padding=op)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(),
                               atol=1e-5, rtol=1e-5)


def _check_gap(x, w, b, got, want, dtype, stride, padding):
    """Where the two maps differ, the exact logits of the two classes lie
    within ``SA.gap_rule`` (relative to the sums of their terms'
    magnitudes)."""
    diff = got != want
    if not bool(diff.any()):
        return 0
    gap, mag = SA.argmax_gap(x, w, b, got, want, stride=stride,
                             padding=padding)
    rule = SA.gap_rule(dtype, w, stride, padding)
    assert bool((gap <= rule * mag)[diff].all()), \
        float((gap / mag)[diff].max())
    return int(diff.sum())


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("cin", [16, 19, 32])
@pytest.mark.parametrize("cout", [11, 19])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_subpixel_argmax_matches_reference(geometry, cin, cout, bias, dtype):
    """K7's plain version (the CPU route of ``ops.classify.subpixel_argmax``)
    against the reference's ``subpixel_argmax``: the (N, 2H, 2W) int32
    map; where they differ, only within the gap rule (``SA.gap_rule``:
    both sum in f32 in other orders, and in bf16 both round the phase
    logit and its sum with the bias); in f32 at most 1e-4 of the pixels."""
    k, p, _ = GEOMETRIES[geometry]
    x, w, wj, b = _case(2, cin, cout, k, bias)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.array(JCL.subpixel_argmax(
        _j(x, jdtype), _j(wj), _j(b), stride=(2, 2), padding=(p, p),
        argmax_tail="resize"))
    xt = _t(x, dtype)
    got = CL.subpixel_argmax(xt, _t(w), _t(b), stride=(2, 2), padding=(p, p))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (
        XSHAPE[0], 2 * XSHAPE[1], 2 * XSHAPE[2])
    assert len(np.unique(want)) > cout // 2
    n = _check_gap(xt, _t(w), _t(b), got, torch.from_numpy(want), dtype,
                   (2, 2), (p, p))
    if dtype == torch.float32:
        assert n <= 1e-4 * want.size


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("cin, cout, bias", [(16, 19, False), (19, 11, True),
                                             (8, 5, True)])
def test_kernel_tables_give_the_plain_logits(geometry, cin, cout, bias):
    """A numpy emulation of K7's f32 loop from what the kernel reads (the
    padded f32 weights and bias and the int32 descriptor, read field by
    field as csrc/subpixel_argmax.cu reads them) gives the f64 phase
    logits within 1e-12 and their first-max argmax; padded classes never
    win. (The bf16 route's tile walk: tests/test_torch_subpixel_pack.py.)"""
    k, p, _ = GEOMETRIES[geometry]
    x, w, _, b = _case(3, cin, cout, k, bias, (2, 5, 7))
    xt = _t(x, torch.float64)
    wp, bp = SA._pack_weights(xt, _t(w), _t(b))
    desc = SA._descriptor(x.shape, w.shape, (2, 2), (p, p))
    n, h, wd, ci, co, pad, nslots = desc[:7]
    assert (n, h, wd, ci, co, nslots) == (2, 5, 7, cin, cout, k * k)
    assert pad == SA.class_pad(cout) and pad % 4 == 0
    ntaps = desc[7:11]
    taps = desc[11:11 + 4 * SA.MAX_TAPS * 3].reshape(4, SA.MAX_TAPS, 3)
    wp, bp = wp.double().numpy(), bp.double().numpy()
    assert not wp[..., co:].any() and not bp[co:].any()
    out = np.zeros((n, 2 * h, 2 * wd, pad))
    for ph in range(4):
        rh, rw = divmod(ph, 2)
        for t in range(ntaps[ph]):
            dy, dx, slot = taps[ph, t]
            for q in range(h):
                for pp in range(wd):
                    if 0 <= q + dy < h and 0 <= pp + dx < wd:
                        out[:, 2 * q + rh, 2 * pp + rw] += \
                            x[:, q + dy, pp + dx].astype(np.float64) @ wp[slot]
    out += bp
    logits, _ = SA.phase_logits(xt, _t(w), _t(b), stride=(2, 2),
                                padding=(p, p))
    np.testing.assert_allclose(out[..., :co], logits.numpy(), atol=1e-12,
                               rtol=0)
    np.testing.assert_array_equal(
        np.argmax(out[..., :co], -1),
        SA.subpixel_argmax_ref(xt, _t(w), _t(b), stride=(2, 2),
                               padding=(p, p)).numpy())


def test_subpixel_argmax_first_max_on_planted_ties():
    """Classes 3 and 7 with the same weights and bias (100 above the
    rest) tie at every pixel: the first, 3, wins everywhere, in f32 and
    bf16."""
    x, w, _, b = _case(4, 16, 11, 3, True, (1, 6, 9))
    w[:, 7] = w[:, 3]
    b[:] = 0.0
    b[[3, 7]] = 100.0
    for dtype in (torch.float32, torch.bfloat16):
        got = K.subpixel_argmax(_t(x, dtype), _t(w), _t(b), stride=(2, 2),
                                padding=(1, 1))
        assert bool((got == 3).all())


def test_packed_weights_follow_the_weights():
    """K7's packed weights, kept between calls, are reused while the
    weight and bias are the same objects at the same versions, and packed
    anew after an in-place update, ``load_state_dict`` or for another
    tensor (the CPU tensors here stand in for the card's)."""
    layer = enn.ConvTranspose(16, 19, 3, stride=2, padding=1,
                              output_padding=1)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.zeros((1, 4, 5, 16), dtype=torch.bfloat16)

    def packed():
        return SA._packed_weights(x, layer.weight, layer.bias)

    def want():   # the bf16 route's [slot][n][k] layout
        w = layer.weight.detach().to(torch.bfloat16)
        return w.permute(2, 3, 1, 0).reshape(9, 19, 16)
    first = packed()
    assert packed() is first and torch.equal(first[0][:9, :19, :16], want())
    with torch.no_grad():
        layer.weight.mul_(2)
    second = packed()
    assert second is not first and torch.equal(second[0][:9, :19, :16],
                                               want())
    layer.load_state_dict({"weight": torch.ones_like(layer.weight),
                           "bias": torch.zeros_like(layer.bias)})
    third = packed()
    assert third is not second and torch.equal(third[0][:9, :19, :16],
                                               want())
    assert not third[1].any()
    other = torch.nn.Parameter(layer.weight.detach().clone())
    assert SA._packed_weights(x, other, layer.bias) is not third


def test_subpixel_argmax_rejects_mismatched_shapes():
    x, w, _, b = _case(5, 16, 11, 2, True, (1, 4, 4))
    with pytest.raises(ValueError):
        K.subpixel_argmax(_t(x), _t(w[:8]), _t(b), stride=2, padding=0)
    with pytest.raises(ValueError):
        K.subpixel_argmax(_t(x), _t(w), _t(b[:5]), stride=2, padding=0)
    with pytest.raises(ValueError):
        K.subpixel_argmax(_t(x)[0], _t(w), _t(b), stride=2, padding=0)


@pytest.mark.parametrize("kernel, stride, padding, output_padding, eligible",
                         [(2, 2, 0, 0, True), (3, 2, 1, 1, True),
                          (4, 2, 1, 0, True), (3, 2, 1, 0, False),
                          (3, 1, 1, 0, False), (1, 2, 0, 1, False)])
def test_subpixel_eligible_is_the_reference_rule(kernel, stride, padding,
                                                 output_padding, eligible):
    from esn_tpu.nn.layers import ConvTranspose as JConvTranspose
    layer = enn.ConvTranspose(4, 3, kernel, stride=stride, padding=padding,
                              output_padding=output_padding)
    ref = JConvTranspose(4, 3, kernel, stride=stride, padding=padding,
                         output_padding=output_padding)
    assert layer.subpixel_eligible() == ref.subpixel_eligible() == eligible


def test_ineligible_head_takes_the_full_output():
    """A transposed conv whose output is not twice its input (k3s2p1,
    output padding 0) predicts by the argmax of its full output, as the
    reference's ``subpixel_predict_tail`` does, with no kernel call."""
    from esn_tpu_torch.models.blocks import subpixel_predict_tail
    layer = enn.ConvTranspose(16, 11, 3, stride=2, padding=1)
    layer.reset_parameters(torch.Generator().manual_seed(1))
    assert not layer.subpixel_eligible()
    y = torch.from_numpy(np.random.RandomState(4)
                         .randn(1, 16, 5, 7).astype(np.float32))
    before = dict(K.LAUNCHES)
    with torch.no_grad():
        got = subpixel_predict_tail(layer, y)
        want = CL.argmax_lastdim(layer(y).permute(0, 2, 3, 1))
    assert got.shape == (1, 9, 13) and torch.equal(got, want)
    assert K.LAUNCHES == before


def test_resize2x_head_argmax_matches_reference():
    """``resize2x_head_argmax`` (the 1x1 head at 1/2, then K1's plain
    version at r = 2) against the reference's premultiplied phase conv,
    f32: mismatches only where the f32 logits of the reference's unfused
    tail put the two classes within 1e-4, as the reference's own test
    allows."""
    rng = np.random.RandomState(3)
    y = rng.randn(2, 12, 32, 16).astype(np.float32)
    wj = (rng.randn(1, 1, 16, 19) * 0.3).astype(np.float32)
    b = (rng.randn(19) * 0.1).astype(np.float32)
    head = enn.Conv(16, 19, 1, bias=True)
    with torch.no_grad():
        head.weight.copy_(torch.from_numpy(wj[0, 0].T[:, :, None, None]))
        head.bias.copy_(torch.from_numpy(b))
    got = CL.resize2x_head_argmax(_t(y), head).numpy()
    want = np.asarray(JCL.resize2x_head_argmax(_j(y), _j(wj), _j(b)))
    assert got.dtype == np.int32 and got.shape == want.shape == (2, 24, 64)
    logits = np.asarray(jax_resize_bilinear(
        JC.conv2d(_j(y), _j(wj), bias=_j(b)), (24, 64)))
    bad = got != want
    srt = np.sort(logits, -1)
    assert bad.mean() <= 1e-3
    assert ((srt[..., -1] - srt[..., -2]) < 1e-4)[bad].all()


@pytest.fixture(scope="module", params=sorted(HEAD_MODELS))
def head_pair(request):
    arch = request.param
    jmodel, shapes = reference_shapes(arch, HW)
    variables, model = calibrated_pair(arch, shapes, HW)
    return arch, jmodel, variables, model


def test_predict_step_matches_the_reference_fused_predict(head_pair):
    """Each model's ``make_predict_step`` against the reference's fused
    predict (its default), f32, under ``_torch_parity.check_predict``'s
    rule."""
    arch, jmodel, variables, model = head_pair
    images = np.random.RandomState(1).randn(2, 3, *HW).astype(np.float32)
    check_predict(jmodel, variables, model, images, 2 * HEAD_MODELS[arch])


@pytest.mark.parametrize("arch", sorted(HEAD_MODELS))
def test_predict_never_builds_full_logits(arch, monkeypatch):
    """Predict never runs the model's forward, the head's
    ``ConvTranspose.forward`` (the seven transposed-conv tails, which call
    ``kernels.subpixel_argmax`` once) or, for FPENet, ``resize_bilinear``
    of class logits (it calls ``kernels.resize_argmax`` once at r = 2 on
    the 1/2-resolution logits)."""
    model = build_model(arch, 19, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    calls = []

    def refuse(*_a, **_k):
        raise AssertionError("predict built the full-resolution logits")
    monkeypatch.setattr(model, "forward", refuse)
    layer = {"enet": "fullconv", "espnet": "up1"}.get(arch, "head")
    if arch == "fpenet":
        real = R.resize_bilinear

        def resize(x, size):
            assert x.shape[1] != 19, "resize_bilinear of class logits"
            return real(x, size)
        monkeypatch.setattr(R, "resize_bilinear", resize)
    else:
        monkeypatch.setattr(getattr(model, layer), "forward", refuse)
    for name in ("subpixel_argmax", "resize_argmax"):
        monkeypatch.setattr(K, name, partial(
            lambda name, real, *a, **k: calls.append(
                (name, tuple(a[0].shape))) or real(*a, **k),
            name, getattr(K, name)))
    images = torch.from_numpy(np.random.RandomState(2)
                              .randn(1, 3, *HW).astype(np.float32))
    pred = make_predict_step(model)(images)
    assert pred.shape == (1, *HW) and pred.dtype == torch.int32
    h, w = HW
    if arch == "fpenet":
        assert calls == [("resize_argmax", (1, h // 2, w // 2, 19))]
    else:
        cin = getattr(model, layer).in_ch
        assert calls == [("subpixel_argmax", (1, h // 2, w // 2, cin))]


def test_fpenet_odd_input_takes_the_full_logits():
    """At an odd side FPENet predicts by the argmax of its full logits,
    as the reference does (no kernel call)."""
    model = build_model("fpenet", 19, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(2)
                         .randn(1, 3, 33, 64).astype(np.float32))
    before = dict(K.LAUNCHES)
    pred = make_predict_step(model)(x)
    with torch.no_grad():
        want = CL.argmax_lastdim(model.eval()(x).permute(0, 2, 3, 1))
    assert torch.equal(pred, want) and K.LAUNCHES == before


def test_heads_refuse_sharded_rows(monkeypatch):
    """Predict runs outside ``spatial.sharded()``; a head reached inside
    it raises (it reads whole images)."""
    from esn_tpu_torch.parallel import spatial
    monkeypatch.setattr(spatial, "axis", lambda: object())
    x, w, _, b = _case(6, 16, 11, 2, True, (1, 4, 4))
    with pytest.raises(RuntimeError, match="whole images"):
        CL.subpixel_argmax(_t(x), _t(w), _t(b), stride=(2, 2), padding=(0, 0))
    with pytest.raises(RuntimeError, match="whole images"):
        CL.resize2x_head_argmax(_t(x), enn.Conv(16, 19, 1, bias=True))
