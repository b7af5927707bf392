"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. This file imports neither JAX nor the reference package, so it runs
on a machine without JAX; ``tests/conftest.py`` imports JAX, so skip it
there:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The same checks at the main path's full shapes are ``chip_smoke.py``.
"""
import contextlib
import importlib

import numpy as np
import pytest
import torch

from esn_tpu_torch.models import build_model
from esn_tpu_torch.ops import kernels as K
from esn_tpu_torch.train.step import make_predict_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    # f32 plain versions in full f32 (cuDNN convs default to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


@contextlib.contextmanager
def _counting_bn(model):
    """K8's launches that ``model``'s BatchNorm calls make on the card,
    counted by forward hooks on any device: an apply a call, the moments
    a training call, a backward a call whose output needs a gradient (a
    train step back-propagates through every BN)."""
    from esn_tpu_torch.nn import BatchNorm
    counts = {"bn_moments": 0, "bn_apply": 0, "bn_bwd": 0}

    def count(m, _, y):
        counts["bn_apply"] += 1
        counts["bn_moments"] += int(m.training)
        counts["bn_bwd"] += int(y.requires_grad)

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, BatchNorm)]
    try:
        yield counts
    finally:
        for h in hooks:
            h.remove()


def _dsconv_args(seed, n, h, w, ci, co, dtype, device):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return (t(rng.randn(n, h, w, ci)).to(dtype), t(rng.randn(3, 3, ci) * 0.3),
            t(rng.rand(ci) + 0.5), t(rng.randn(ci) * 0.1),
            t(rng.randn(ci, co) * 0.2), t(rng.rand(co) + 0.5),
            t(rng.randn(co) * 0.1))


@pytest.mark.parametrize("dtype, atol, rtol", [
    (torch.float32, 1e-4, 1e-4),       # both sum in f32, in other orders
    (torch.bfloat16, 5e-2, 2e-2),      # output rounds to bf16, mid and pw
])                                     # too; plain rounds its dw result
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape, co, acts", [
    ((2, 16, 16, 32), 48, ("relu", "relu")),
    ((1, 9, 15, 24), 16, ("relu6", "none")),       # odd H/W, K padded to 32
    ((2, 17, 33, 128), 128, ("relu", "relu6")),    # 128 -> 128, > 48 KB smem
    ((2, 21, 37, 48), 64, ("relu", "relu")),       # w_out % 16 != 0, 2 tiles
    ((1, 6, 9, 20), 24, ("none", "relu")),         # Cin*2 bytes not 16-whole
    ((1, 3, 4, 6), 8, ("relu", "none")),           # Cin*4 not 16-whole
    ((2, 64, 128, 32), 64, ("relu", "relu")),      # ContextNet shallow.ds1
    ((2, 32, 64, 64), 128, ("relu", "relu")),      # ContextNet shallow.ds2
])
def test_dsconv_kernel_matches_plain(cuda, shape, co, acts, stride, dtype,
                                     atol, rtol):
    args = _dsconv_args(0, *shape, co, dtype, cuda)
    kw = dict(stride=stride, act1=acts[0], act2=acts[1])
    before = K.LAUNCHES["dsconv"]
    got = K.fused_dsconv(*args, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["dsconv"] == before + 1
    want = K.dsconv_ref(*args, **kw)
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def _dyadic(seed, n, h, w, ci, co, device):
    """bf16 K2 inputs with x, dw, a1 and b1 on a dyadic grid: the depthwise
    sums and their affine are exact in f32 in any order, so kernel and
    emulation round the same mid."""
    q = lambda t, k: torch.round(t * k) / k  # noqa: E731
    x, dw, a1, b1, pw, a2, b2 = _dsconv_args(seed, n, h, w, ci, co,
                                             torch.float32, device)
    return (q(x * 2, 8).to(torch.bfloat16), q(dw, 32), q(a1, 16),
            q(b1, 256), pw, a2, b2)


# bf16 against dsconv_kernel_rounding, which rounds where the kernel does
# (mid after affine + act, pw, the output once): the outputs differ only
# where the two f32 orders of the product's sum straddle a bf16 rounding,
# at <= 2 + 1e-3 of the elements, each by one bf16 step
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape, co", [((2, 16, 16, 32), 48),
                                       ((1, 9, 15, 24), 16),
                                       ((2, 17, 33, 128), 128),
                                       ((1, 6, 9, 20), 24)])
def test_dsconv_kernel_rounding_bf16(cuda, shape, co, stride):
    args = _dyadic(5, *shape, co, cuda)
    kw = dict(stride=stride, act1="relu6", act2="relu")
    got = K.fused_dsconv(*args, **kw)
    want = K.dsconv_kernel_rounding(*args, **kw)
    differ, far = K.bf16_step_gap(got, want)
    assert differ <= 2 + 1e-3 * got.numel() and far == 0, (differ, far)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dsconv_kernel_takes_misaligned_x(cuda, dtype):
    """x one element off a 16-byte boundary: the halo is staged element by
    element and the result equals that of an aligned copy, bit for bit."""
    args = _dsconv_args(6, 2, 11, 19, 32, 48, dtype, cuda)
    x = args[0]
    es, nbytes = x.element_size(), x.numel() * x.element_size()
    buf = torch.empty(nbytes + 16, dtype=torch.uint8, device=cuda)
    shifted = buf[es:es + nbytes].view(dtype).view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    for stride in (1, 2):
        a = K.fused_dsconv(*args, stride=stride)
        b = K.fused_dsconv(shifted, *args[1:], stride=stride)
        assert torch.equal(a, b)


def test_dsconv_wrapper_raises_on_cuda(cuda):
    args = _dsconv_args(1, 1, 8, 8, 8, 8, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_dsconv(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(TypeError, match="dtype"):
        K.fused_dsconv(args[0].half(), *args[1:])
    with pytest.raises(RuntimeError, match="forward-only"):
        K.fused_dsconv(args[0].requires_grad_(), *args[1:])
    with pytest.raises(ValueError, match="multiple of 8"):
        K.fused_dsconv(*_dsconv_args(1, 1, 8, 8, 8, 12, torch.float32, cuda))


# K5 and K6, the fixed-order backward of the bilinear resize and of the
# adaptive pool, against their plain versions (f32 within 1e-5 of the
# largest |gradient|, bf16 within one bf16 step) and torch's own backward
# (f32), NCHW and channels_last; two launches bit for bit. K5's cases
# reach both of its routes and their edges: the fan-in route (fewer than
# 2^16 input elements) and the streaming route just above and below that
# threshold, runs longer than the fan-in's 32 lanes, PPM's bin 1 to
# config 5's and CamVid's maps, streaming bands cut at odd sizes, the
# ratio route (scale factors), downscales on both routes, and 19
# channels of f32 (76-byte pixels, so rows that start off a 16-byte
# boundary).
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("kind, g_shape, in_hw, scales", [
    ("resize", (2, 5, 32, 48), (4, 6), None),          # x8, fan-in
    ("resize", (2, 5, 29, 11), (13, 17), None),        # odd, both ways
    ("resize", (2, 3, 23, 30), (1, 1), None),          # PPM's bin 1 to CamVid
    ("resize", (2, 3, 32, 64), (1, 1), None),          # and to config 5's
    ("resize", (2, 3, 70, 40), (1, 1), None),          # a run of 70 rows
    ("resize", (2, 3, 22, 30), (90, 120), None),       # a downscale, fan-in
    ("resize", (2, 64, 22, 30), (90, 120), None),      # a downscale, streaming
    ("resize", (2, 8, 126, 128), (63, 64), None),      # 64512 inputs: fan-in
    ("resize", (2, 8, 128, 128), (64, 64), None),      # 65536: streaming
    ("resize", (2, 40, 296, 360), (37, 45), None),     # odd bands, x8
    ("resize", (4, 19, 256, 512), (32, 64), None),     # 19 channels, x8
    ("resize", (2, 5, 32, 40), (4, 5), (8.0, 8.0)),    # the ratio route
    ("resize", (2, 3, 15, 10), (5, 7), (3.0, 1.5)),    # odd ratios
    ("resize", (2, 40, 132, 96), (33, 48), (4.0, 2.0)),  # ratio, streaming
    ("pool", (2, 5, 6, 6), (23, 30), None),
    ("pool", (2, 5, 1, 1), (32, 64), None),
    ("pool", (2, 5, 2, 3), (13, 17), None),
    ("pool", (2, 19, 6, 6), (32, 64), None),           # 19 channels
    ("pool", (2, 128, 3, 3), (23, 30), None),          # PPM's, 16-byte stores
])
def test_backward_kernels_match_plain(cuda, kind, g_shape, in_hw, scales,
                                      dtype, channels_last):
    g = torch.from_numpy(np.random.RandomState(4).randn(*g_shape)).to(
        cuda, dtype)
    if channels_last:
        g = g.contiguous(memory_format=torch.channels_last)
    if kind == "resize":
        args = (in_hw, scales)
        kernel, plain = K.resize_bilinear_bwd, K.resize_bilinear_bwd_ref
        name = "resize_bilinear_bwd"
    else:
        args = (in_hw,)
        kernel, plain = K.adaptive_pool_bwd, K.adaptive_pool_bwd_ref
        name = "adaptive_pool_bwd"
    before = K.LAUNCHES[name]
    got, again, want = kernel(g, *args), kernel(g, *args), plain(g, *args)
    assert torch.equal(got, again)
    assert got.dtype == dtype and got.shape == g_shape[:2] + in_hw
    fmt = (torch.channels_last if channels_last and not g.is_contiguous()
           else torch.contiguous_format)
    assert got.is_contiguous(memory_format=fmt)
    assert want.is_contiguous(memory_format=fmt)
    if dtype == torch.bfloat16:
        assert K.bf16_step_gap(got, want)[1] == 0
    else:
        tol = (1e-12 if dtype == torch.float64 else 1e-5) * max(
            1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol
    if dtype == torch.float32 and kind == "resize":
        sh, sw = scales if scales is not None else (None, None)
        lib = torch.ops.aten.upsample_bilinear2d_backward(
            g, list(g_shape[2:]), list(g_shape[:2] + in_hw), False, sh, sw)
        assert float((got - lib).abs().max()) <= 1e-5 * max(
            1.0, float(lib.abs().max()))
    assert K.LAUNCHES[name] == before + 2


RB = importlib.import_module("esn_tpu_torch.ops.kernels.resize_bilinear_bwd")


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("g_shape, in_hw, scales", [
    ((2, 5, 32, 48), (4, 6), None),
    ((2, 3, 32, 64), (1, 1), None),
    ((2, 3, 32, 64), (6, 6), None),
    ((2, 8, 128, 128), (64, 64), None),
    ((2, 19, 96, 64), (12, 8), (8.0, 8.0)),
    ((2, 64, 22, 30), (90, 120), None),
    ((2, 3, 29, 11), (13, 17), None),
])
def test_backward_resize_routes_give_the_same_bits(cuda, g_shape, in_hw,
                                                   scales, dtype,
                                                   channels_last):
    """K5's two routes sum each element's terms in one order, so the
    plan's choice moves no bit: the streaming and the fan-in route on the
    same g are equal."""
    g = torch.from_numpy(np.random.RandomState(7).randn(*g_shape)).to(
        cuda, dtype)
    if channels_last:
        g = g.contiguous(memory_format=torch.channels_last)
    cl = RB._channels_last(g)
    out = [torch.empty(g_shape[:2] + in_hw, dtype=dtype, device=cuda,
                       memory_format=torch.channels_last if cl
                       else torch.contiguous_format) for _ in range(2)]
    for gx, route in zip(out, (RB.STREAM, RB.FANIN)):
        call = RB._call(tuple(g.shape), in_hw, dtype, cl, scales,
                        g.get_device(), route)
        assert call.plan.route == route
        RB._launch(g, gx, call)
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ratio", [2, 4, 8])
def test_backward_resize_window_equals_the_whole(cuda, ratio, dtype,
                                                 channels_last):
    """K5 on a window of rows, as ``ops/resize.py``'s sharded backward
    forms it (input rows [lo, hi) resized by the global scale factors,
    the output-gradient rows [lo r, hi r) that the window's resize
    makes), equals the whole tensor's K5 bit for bit on every row whose
    run lies inside the window (all but its first and last), though the
    whole tensor streams and the window takes the fan-in route."""
    n, c, h, w, lo, hi = 2, 16, 64, 64, 21, 31
    scales = (float(ratio), float(ratio))
    g = torch.from_numpy(np.random.RandomState(ratio).randn(
        n, c, h * ratio, w * ratio)).to(cuda, dtype)
    if channels_last:
        g = g.contiguous(memory_format=torch.channels_last)
    win = g[:, :, lo * ratio:hi * ratio]
    win = win.contiguous(memory_format=torch.channels_last if channels_last
                         else torch.contiguous_format)
    cl = RB._channels_last(g)
    assert RB._call(tuple(g.shape), (h, w), dtype, cl, scales,
                    g.get_device()).plan.route == RB.STREAM
    assert RB._call(tuple(win.shape), (hi - lo, w), dtype, cl, scales,
                    g.get_device()).plan.route == RB.FANIN
    whole = K.resize_bilinear_bwd(g, (h, w), scales)
    part = K.resize_bilinear_bwd(win, (hi - lo, w), scales)
    assert torch.equal(part[:, :, 1:-1], whole[:, :, lo + 1:hi - 1])


def test_backward_resize_offsets_past_2_31(cuda):
    """K5 on a bf16 g of more than 2^31 elements (4.3 GB, channels_last,
    x8): the first and the last input rows against the plain version on
    the output-gradient rows that read them, within one bf16 step."""
    n, c, ho, wo = 1, 16, 8192, 16400
    assert n * c * ho * wo > 2 ** 31
    gen = torch.Generator(device=cuda).manual_seed(0)
    g = torch.randn((n, ho, wo, c), generator=gen, device=cuda,
                    dtype=torch.bfloat16).permute(0, 3, 1, 2)
    h, w, r = ho // 8, wo // 8, 8
    got = K.resize_bilinear_bwd(g, (h, w), (8.0, 8.0))
    torch.cuda.synchronize()
    top = K.resize_bilinear_bwd_ref(g[:, :, :5 * r], (5, w), (8.0, 8.0))
    bottom = K.resize_bilinear_bwd_ref(g[:, :, (h - 5) * r:], (5, w),
                                       (8.0, 8.0))
    assert K.bf16_step_gap(got[:, :, :4], top[:, :, :4])[1] == 0
    assert K.bf16_step_gap(got[:, :, h - 4:], bottom[:, :, 1:])[1] == 0


def test_backward_pool_repeats_at_ppm_shapes(cuda):
    """K6 at PPM's four pools of config 5 (f32, channels_last): two
    launches give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    for b in (1, 2, 3, 6):
        g = torch.randn((8, 128, b, b), generator=gen, device=cuda
                        ).contiguous(memory_format=torch.channels_last)
        assert torch.equal(K.adaptive_pool_bwd(g, (32, 64)),
                           K.adaptive_pool_bwd(g, (32, 64)))


def test_backward_kernels_route_a_train_step(cuda):
    """resize_bilinear and adaptive_avg_pool2d on a CUDA tensor that needs
    a gradient record K5's and K6's Functions; two backward passes give
    the same bits."""
    from esn_tpu_torch.ops import pooling as P
    from esn_tpu_torch.ops import resize as R
    x = torch.randn(2, 8, 32, 64, device=cuda).contiguous(
        memory_format=torch.channels_last)
    grads = []
    for _ in range(2):
        t = x.detach().clone().requires_grad_()
        y = R.resize_bilinear(P.adaptive_avg_pool2d(t, 3), (32, 64))
        z = R.resize_bilinear(t, (128, 256))
        assert type(y.grad_fn).__name__ == "BilinearResizeBackward"
        (y.square().sum() + z.square().sum()).backward()
        grads.append(t.grad)
    assert torch.equal(*grads)


def test_backward_wrappers_raise_on_cuda(cuda):
    g = torch.zeros(1, 2, 4, 4, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        K.resize_bilinear_bwd(g, (2, 2))
    with pytest.raises(TypeError, match="dtype"):
        K.adaptive_pool_bwd(g, (8, 8))


# The band tiling at its edges (bands of 8 low-res rows, tiles of ~256/r
# low-res columns), and C above 20, where logits are read from shared
# memory rather than registers.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, r", [
    ((2, 8, 24, 19), 8),
    ((1, 5, 7, 19), 3),
    ((2, 6, 6, 2), 2),
    ((1, 11, 70, 19), 8),      # h % 8 == 3; 3 column tiles, the last partial
    ((2, 5, 300, 19), 1),      # r = 1, h < 8; 3 tiles
    ((1, 13, 140, 40), 2),     # C = 40 (shared memory); 2-3 tiles
    ((1, 9, 120, 64), 5),      # C = 64 (shared memory), r = 5; 5 tiles
    ((1, 17, 45, 2), 3),       # C = 2, 3 bands
    ((2, 64, 128, 19), 8),     # EDANet's predict tail at 512x1024
])
def test_resize_argmax_kernel_matches_plain(cuda, shape, r, dtype):
    """Equal to the plain version except where the two classes' f32
    upsampled logits lie within the rounding gap (1e-5 for f32; for bf16
    the plain version rounds them to bf16, one ulp <= 2^-7 of the value)."""
    y = torch.from_numpy(np.random.RandomState(2).randn(*shape)
                         .astype(np.float32)).to(cuda, dtype)
    before = K.LAUNCHES["resize_argmax"]
    got = K.resize_argmax(y, r)
    torch.cuda.synchronize()
    assert K.LAUNCHES["resize_argmax"] == before + 1
    want = K.resize_argmax_ref(y, r)
    assert got.shape == want.shape and got.dtype == torch.int32
    n, h, w, c = shape
    up = torch.nn.functional.interpolate(
        y.permute(0, 3, 1, 2).float(), size=(h * r, w * r), mode="bilinear",
        align_corners=False)
    a = up.gather(1, got.long()[:, None])[:, 0]
    b = up.gather(1, want.long()[:, None])[:, 0]
    gap = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    tol = gap * torch.clamp(torch.maximum(a.abs(), b.abs()), min=1.0)
    assert bool(((a - b).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resize_argmax_kernel_takes_misaligned_y(cuda, dtype):
    """y one element off a 16-byte boundary: the band is staged element by
    element and the map equals that of an aligned copy, bit for bit."""
    y = torch.from_numpy(np.random.RandomState(8).randn(2, 11, 45, 19)
                         .astype(np.float32)).to(cuda, dtype)
    es, nbytes = y.element_size(), y.numel() * y.element_size()
    buf = torch.empty(nbytes + 16, dtype=torch.uint8, device=cuda)
    shifted = buf[es:es + nbytes].view(dtype).view(y.shape)
    shifted.copy_(y)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    for r in (3, 8):
        assert torch.equal(K.resize_argmax(y, r), K.resize_argmax(shifted, r))


def test_resize_argmax_kernel_is_deterministic(cuda):
    y = torch.from_numpy(np.random.RandomState(9).randn(2, 16, 40, 19)
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    assert torch.equal(K.resize_argmax(y, 8), K.resize_argmax(y, 8))


def test_resize_argmax_kernel_at_r2(cuda):
    """K1 at r = 2 (FPENet's x2 head), at a batch-2 slice of its config-3
    shape and at an odd one: the plain version's map but at near-ties,
    two launches bit for bit."""
    for shape in ((2, 128, 256, 19), (1, 17, 45, 19)):
        for dtype in (torch.float32, torch.bfloat16):
            y = torch.from_numpy(np.random.RandomState(10).randn(*shape)
                                 .astype(np.float32)).to(cuda, dtype)
            got, want = K.resize_argmax(y, 2), K.resize_argmax_ref(y, 2)
            up = torch.nn.functional.interpolate(
                y.permute(0, 3, 1, 2).float(), scale_factor=2,
                mode="bilinear", align_corners=False)
            a = up.gather(1, got.long()[:, None])[:, 0]
            b = up.gather(1, want.long()[:, None])[:, 0]
            gap = 1e-5 if dtype == torch.float32 else 2.0 ** -7
            tol = gap * torch.clamp(torch.maximum(a.abs(), b.abs()), min=1.0)
            assert bool(((a - b).abs() <= tol).all())
            assert torch.equal(got, K.resize_argmax(y, 2))


def test_resize_argmax_first_max(cuda):
    got = K.resize_argmax(torch.zeros((1, 4, 8, 6), device=cuda), 2)
    assert bool((got == 0).all())


def test_fastscnn_predict_on_cuda_matches_cpu(cuda):
    """f32 predict through both kernels on the card == the CPU's predict
    through the plain versions, except at near-ties (rate <= 1e-4)."""
    model = build_model("fastscnn", 19, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.RandomState(3)
                              .randn(2, 3, 128, 256).astype(np.float32))
    want = make_predict_step(model)(images)
    before = dict(K.LAUNCHES)
    got = make_predict_step(model.to(cuda))(images.to(cuda))
    torch.cuda.synchronize()
    assert K.LAUNCHES["dsconv"] == before["dsconv"] + 4
    assert K.LAUNCHES["resize_argmax"] == before["resize_argmax"] + 1
    assert got.shape == want.shape and got.dtype == torch.int32
    assert (got.cpu() != want).float().mean() <= 1e-4


def _resize_ce_case(seed, b, h, w, c, r, weighted, device, ignore_all=False):
    rng = np.random.RandomState(seed)
    z = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(device)
    lab = rng.randint(0, c, (b, h * r, w * r)).astype(np.int32)
    lab[rng.rand(*lab.shape) < 0.05] = 255           # ~5% ignored
    if ignore_all:
        lab[:] = 255
    cw = (torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32)).to(device)
          if weighted else None)
    return z, torch.from_numpy(lab).to(device), cw


def _resize_ce_value_and_grad(fn, z, lab, cw, r, eps):
    zz = z.clone().requires_grad_()
    s, n = fn(zz, lab, cw, r=r, ignore_index=255, label_smoothing=eps)
    (s / torch.clamp(n, min=1e-8)).backward()
    return s.detach(), n.detach(), zz.grad


# |dS| <= 1e-5 |S| (f32 sums over the pixels in other orders), N the
# same; dz rel-L2 <= 1e-4, as tests/test_pallas_resize_ce.py
@pytest.mark.parametrize("shape, r, eps, weighted", [
    ((2, 8, 24, 19), 8, 0.0, True),
    ((2, 13, 21, 19), 3, 0.1, False),     # odd h, w; smoothing
    ((1, 9, 7, 5), 16, 0.0, True),        # r = 16
    ((1, 6, 10, 40), 2, 0.1, True),       # C > 32: two class chunks
    ((3, 1, 5, 3), 4, 0.0, True),         # h = 1
    ((1, 7, 12, 64), 4, 0.1, True),       # C = 64: logits from shared memory
])
def test_resize_ce_kernel_matches_plain(cuda, shape, r, eps, weighted):
    z, lab, cw = _resize_ce_case(0, *shape, r, weighted, cuda)
    before = dict(K.LAUNCHES)
    s, n, dz = _resize_ce_value_and_grad(K.resize_ce_sums, z, lab, cw, r, eps)
    torch.cuda.synchronize()
    assert K.LAUNCHES["resize_ce_fwd"] == before["resize_ce_fwd"] + 1
    assert K.LAUNCHES["resize_ce_bwd"] == before["resize_ce_bwd"] + 1
    s0, n0, dz0 = _resize_ce_value_and_grad(K.resize_ce_sums_ref, z, lab, cw,
                                            r, eps)
    assert abs(float(s - s0)) <= 1e-5 * abs(float(s0))
    assert abs(float(n - n0)) <= 1e-5 * abs(float(n0))
    assert float(torch.linalg.norm(dz - dz0) / torch.linalg.norm(dz0)) <= 1e-4


# The band backward at its edges, against the plain version (tolerances
# as above): h not a multiple of the band (8 rows) and h < 8; r = 2, 3,
# 16; several column tiles, the last one partial; a band whose labels
# are all ignored; the clamped first and last rows and columns, whose
# halo entries fold back, held separately.
@pytest.mark.parametrize("shape, r, ignored_rows", [
    ((2, 19, 12, 19), 4, None),           # h % 8 == 3
    ((1, 5, 9, 19), 8, None),             # h < 8
    ((1, 16, 150, 7), 2, (8, 16)),        # r = 2: 2 column tiles; band 2
    ((2, 11, 90, 19), 3, None),           # r = 3: 85 columns a tile
    ((1, 9, 40, 5), 16, (0, 8)),          # r = 16: 3 tiles; band 1 ignored
    ((2, 24, 40, 19), 8, None),           # 3 full bands, 2 column tiles
])
def test_resize_ce_band_edges(cuda, shape, r, ignored_rows):
    z, lab, cw = _resize_ce_case(7, *shape, r, True, cuda)
    if ignored_rows is not None:
        lab[:, ignored_rows[0] * r:ignored_rows[1] * r] = 255
    s, n, dz = _resize_ce_value_and_grad(K.resize_ce_sums, z, lab, cw, r, 0.1)
    s0, n0, dz0 = _resize_ce_value_and_grad(K.resize_ce_sums_ref, z, lab, cw,
                                            r, 0.1)
    assert abs(float(s - s0)) <= 1e-5 * abs(float(s0))
    assert abs(float(n - n0)) <= 1e-5 * abs(float(n0))
    def close(a, b):         # rel-L2 <= 1e-4 (both 0 where no pixel taps)
        return float(torch.linalg.norm(a - b)) <= 1e-4 * float(
            torch.linalg.norm(b))
    assert close(dz, dz0)
    for a, b in ((dz[:, 0], dz0[:, 0]), (dz[:, -1], dz0[:, -1]),
                 (dz[:, :, 0], dz0[:, :, 0]), (dz[:, :, -1], dz0[:, :, -1])):
        assert close(a, b)
    if ignored_rows is not None:
        lo, hi = ignored_rows        # rows no valid pixel taps stay 0
        assert float(dz[:, lo + 1:hi - 1].abs().max()) == 0.0
    again = _resize_ce_value_and_grad(K.resize_ce_sums, z, lab, cw, r, 0.1)
    assert torch.equal(dz, again[2])


def test_resize_ce_kernel_all_ignored(cuda):
    z, lab, cw = _resize_ce_case(1, 1, 4, 4, 19, 8, True, cuda,
                                 ignore_all=True)
    s, n, dz = _resize_ce_value_and_grad(K.resize_ce_sums, z, lab, cw, 8, 0.0)
    assert float(s) == 0.0 and float(n) == 0.0
    assert float(dz.abs().max()) == 0.0


def test_resize_ce_kernel_is_deterministic(cuda):
    """No float atomics: two launches give bit-identical S, N and dz."""
    z, lab, cw = _resize_ce_case(2, 2, 16, 32, 19, 8, True, cuda)
    a = _resize_ce_value_and_grad(K.resize_ce_sums, z, lab, cw, 8, 0.0)
    b = _resize_ce_value_and_grad(K.resize_ce_sums, z, lab, cw, 8, 0.0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("shape, r", [((2, 13, 21, 19), 3), ((1, 6, 10, 40), 2)])
def test_resize_ce_kernel_takes_wide_logits(cuda, shape, r):
    """Logits x100: a class's logits spread by more than 64 between two
    tap rows, where the forward takes each pixel's own max rather than the
    tap rows' (whose exp would underflow); tolerances as above."""
    z, lab, cw = _resize_ce_case(6, *shape, r, True, cuda)
    z = z * 100
    s, n, dz = _resize_ce_value_and_grad(K.resize_ce_sums, z, lab, cw, r, 0.1)
    s0, n0, dz0 = _resize_ce_value_and_grad(K.resize_ce_sums_ref, z, lab, cw,
                                            r, 0.1)
    assert abs(float(s - s0)) <= 1e-5 * abs(float(s0))
    assert abs(float(n - n0)) <= 1e-5 * abs(float(n0))
    assert float(torch.linalg.norm(dz - dz0) / torch.linalg.norm(dz0)) <= 1e-4


def test_resize_ce_kernel_takes_misaligned_z(cuda):
    """z one float off a 16-byte boundary: staged element by element, with
    S, N and dz equal to an aligned copy's, bit for bit."""
    z, lab, cw = _resize_ce_case(5, 2, 11, 45, 19, 4, True, cuda)
    buf = torch.empty(z.numel() + 4, device=cuda)
    shifted = buf[1:1 + z.numel()].view(z.shape)
    shifted.copy_(z)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    def run(t):
        t = t.detach().requires_grad_()     # the same storage: no copy
        s, n = K.resize_ce_sums(t, lab, cw, r=4, label_smoothing=0.1)
        (s / torch.clamp(n, min=1e-8)).backward()
        return s.detach(), n.detach(), t.grad
    a, b = run(z), run(shifted)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_resize_ce_wrapper_raises_on_cuda(cuda):
    z, lab, cw = _resize_ce_case(3, 1, 4, 6, 5, 2, True, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.resize_ce_sums(z.transpose(1, 2).contiguous().transpose(1, 2),
                         lab, cw, r=2)
    with pytest.raises(TypeError, match="int32"):
        K.resize_ce_sums(z, lab.long(), cw, r=2)
    with pytest.raises(ValueError, match="labels"):
        K.resize_ce_sums(z, lab[:, :, :-2], cw, r=2)
    with pytest.raises(TypeError, match="float32"):
        K.resize_ce_sums(z.double(), lab, cw, r=2)


def test_fastscnn_train_step_on_cuda_matches_cpu(cuda):
    """One f32 step (adam + poly, fused resize-CE, dropout off) on the
    card through the kernel == the same step on the CPU through the plain
    version: loss rel 1e-5; per-leaf gradient rel-L2 <= 3e-2 (+1e-6 abs):
    at this small batch the f32 gradient is ill-conditioned (BN over 2
    values in the PPM; the reference's own f32 gradients lie up to 3.9e-2
    from an f64 oracle, tests/test_torch_train.py), and cuDNN and the CPU
    sum in other orders (largest gap read on an H100: 1.2e-2, a BN bias
    of the head); params within 2*lr (Adam's ~sign(g) first update); BN
    stats 1e-4."""
    import copy
    from functools import partial
    from esn_tpu_torch.train import losses as L
    from esn_tpu_torch.train.optimizers import build_optimizer
    from esn_tpu_torch.train.schedules import build_schedule
    from esn_tpu_torch.train.step import make_train_step
    rng = np.random.RandomState(4)
    images = torch.from_numpy(rng.randn(2, 3, 128, 256).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 19, (2, 128, 256))
                              .astype(np.int32))
    labels[:, 60:68] = 255
    cw = torch.from_numpy((rng.rand(19) + 0.5).astype(np.float32))
    lr = 4.5e-4
    cpu = build_model("fastscnn", 19, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    cpu.head.drop.rate = 0.0
    gpu = copy.deepcopy(cpu).to(cuda)
    runs = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        fused, method = L.fused_resize_ce_spec(model, "ce")
        opt = build_optimizer("adam", model.parameters())
        step = make_train_step(
            model, partial(fused, num_classes=19, class_weights=cw.to(dev)),
            opt, schedule=build_schedule("poly", lr, 100), fwd_method=method)
        before = dict(K.LAUNCHES)
        with _counting_bn(model) as bn:
            loss = float(step({"image": images.to(dev),
                               "label": labels.to(dev)})["loss"])
        launched = {k: K.LAUNCHES[k] - before[k] for k in before}
        runs.append((model, loss, launched))
    (_, want, none), (_, got, launched) = runs
    assert none == {k: 0 for k in none}
    assert launched == {"dsconv": 0, "resize_argmax": 0,
                        "resize_ce_fwd": 1, "resize_ce_bwd": 1, "cgblock": 0,
                        "resize_bilinear_bwd": 5, "adaptive_pool_bwd": 4,
                        "subpixel_argmax": 0, **bn}
    assert abs(got - want) <= 1e-5 * abs(want)
    excess = {}
    for (name, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        g, g0 = q.grad.cpu(), p.grad
        d, n0 = float(torch.linalg.norm(g - g0)), float(torch.linalg.norm(g0))
        excess[name] = (d - 3e-2 * n0 - 1e-6, d / max(n0, 1e-30))
        assert float((q.detach().cpu() - p.detach()).abs().max()) <= (
            2 * lr + 1e-7)
    worst = sorted(excess.items(), key=lambda kv: -kv[1][0])[:8]
    assert worst[0][1][0] <= 0, worst
    for (name, b), b2 in zip(cpu.named_buffers(), gpu.buffers()):
        torch.testing.assert_close(b2.cpu(), b, atol=1e-4, rtol=1e-4)


def _cgblock_args(seed, n, h, w, c, dtype, device):
    """Seeded K4 inputs; in bf16, x, w1, a1 and b1 on a dyadic grid, so the
    reduce and its affine are exact in f32 in any order."""
    rng = np.random.RandomState(seed)
    half = c // 2
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    q = ((lambda a, k: np.round(a * k) / k) if dtype == torch.bfloat16
         else (lambda a, k: a))
    return (t(q(rng.randn(n, h, w, c), 8)).to(dtype),
            t(q(rng.randn(c, half) * 0.3, 32)),
            t(q(rng.randn(half) * 0.1 + 1.0, 16)),
            t(q(rng.randn(half) * 0.1, 256)),
            t(rng.uniform(0.1, 0.4, half)), t(rng.randn(3, 3, half) * 0.3),
            t(rng.randn(3, 3, half) * 0.3), t(rng.randn(c) * 0.1 + 1.0),
            t(rng.randn(c) * 0.1), t(rng.uniform(0.1, 0.4, c)))



# j: f32 (TF32 off) both sum in f32, in other orders: 1e-4. bf16: j rounds
# to bf16 and the plain version also rounds loc/sur (the kernel does not),
# and y can round the other way where the two f32 reduce sums straddle a
# rounding boundary: one bf16 rounding of a value as large as the largest
# |j|, atol = 2^-7 max|j|, rtol = 2^-7. Sums: |d| <= tol * sum|j| per
# (n, c), f32 association (1e-5); in bf16 the kernel sums the f32 j, the
# plain version the rounded j (2^-8). bf16 also against the emulation of
# the kernel's rounding, whose y equals the kernel's on the grid inputs: j
# differs only where the f32 order of the tap sums crosses a bf16 rounding,
# at <= 2 + 1e-3 of the elements, each by one bf16 step (+ 2^-16 max|j|);
# sums within 1e-5.
@pytest.mark.parametrize("dtype, sum_tol", [(torch.float32, 1e-5),
                                            (torch.bfloat16, 4e-3)])
@pytest.mark.parametrize("shape, d", [
    ((2, 16, 40, 64), 2),
    ((1, 12, 20, 128), 4),
    ((2, 13, 21, 64), 2),       # odd H, W
    ((1, 9, 7, 24), 4),         # d >= H/2, half = 12
    ((2, 6, 5, 24), 4),         # d > H/2 and > W/2
    ((2, 16, 20, 24), 1),
    ((2, 11, 13, 18), 3),       # half = 9: x staged element by element
    # the strip walk's edges (strips of 32 columns, segments of 8 or more
    # rows, steps of up to 8 y rows, a ring of rows + 2d)
    ((1, 5, 3, 16), 6),         # H, W < d < a strip
    ((3, 33, 65, 64), 2),       # a last strip of 1 column, a last segment of 1 row
    ((1, 70, 40, 32), 9),       # d > the rows of a step; 2 strips, the last of 8
    ((1, 40, 70, 128), 4),      # N = 1 at stage3's width; 3 strips, 5 segments
    ((2, 8, 96, 64), 2),        # H = one segment; 3 full strips
    ((1, 64, 34, 8), 1),        # half = 4: one bf16 group half empty
])
def test_cgblock_kernel_matches_plain(cuda, shape, d, dtype, sum_tol):
    args = _cgblock_args(0, *shape, dtype, cuda)
    before = K.LAUNCHES["cgblock"]
    j, s = K.fused_cgblock_pre(*args, d=d)
    torch.cuda.synchronize()
    assert K.LAUNCHES["cgblock"] == before + 1
    j0, s0 = K.cgblock_pre_ref(*args, d=d)
    assert j.shape == j0.shape and j.dtype == dtype and s.shape == s0.shape
    if dtype == torch.float32:
        atol = rtol = 1e-4
    else:
        atol, rtol = 2.0 ** -7 * float(j0.float().abs().max()), 2.0 ** -7
    torch.testing.assert_close(j.float(), j0.float(), atol=atol, rtol=rtol)
    scale = j0.float().abs().sum((1, 2))
    assert bool(((s - s0).abs() <= sum_tol * scale).all())
    if dtype == torch.bfloat16:
        differ, far, sum_rel = K.bf16_rounding_gap(
            j, s, *K.cgblock_pre_kernel_rounding(*args, d=d))
        assert differ <= 2 + 1e-3 * j.numel() and far == 0, (differ, far)
        assert sum_rel <= 1e-5


def test_cgblock_kernel_is_deterministic(cuda):
    """No float atomics: two launches give bit-identical j and sums."""
    args = _cgblock_args(1, 2, 24, 40, 128, torch.bfloat16, cuda)
    a = K.fused_cgblock_pre(*args, d=4)
    b = K.fused_cgblock_pre(*args, d=4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, d", [((3, 33, 65, 64), 2),
                                      ((2, 40, 70, 128), 4),
                                      ((2, 11, 13, 18), 3)])
def test_cgblock_result_does_not_depend_on_the_grid(cuda, shape, d, dtype):
    """The persistent grid capped at 1, 3 and 7 blocks (other blocks take
    other units, down to one block that takes them all in turn) and the
    uncapped grid (more resident blocks than units) give bit-identical j
    and sums."""
    args = _cgblock_args(4, *shape, dtype, cuda)
    want = K.fused_cgblock_pre(*args, d=d)
    for blocks in (1, 3, 7):
        got = K.fused_cgblock_pre(*args, d=d, max_blocks=blocks)
        assert all(torch.equal(u, v) for u, v in zip(got, want)), blocks


def test_cgblock_kernel_takes_misaligned_x(cuda):
    """x 2 bytes off a 16-byte boundary: the kernel stages it element by
    element and gives what it gives for an aligned copy."""
    args = _cgblock_args(3, 1, 10, 12, 64, torch.bfloat16, cuda)
    x = args[0]
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    a = K.fused_cgblock_pre(*args, d=2)
    b = K.fused_cgblock_pre(shifted, *args[1:], d=2)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_cgblock_wrapper_raises_on_cuda(cuda):
    args = _cgblock_args(2, 1, 8, 8, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_cgblock_pre(args[0].transpose(1, 2), *args[1:], d=2)
    with pytest.raises(TypeError, match="dtype"):
        K.fused_cgblock_pre(args[0].half(), *args[1:], d=2)
    with pytest.raises(RuntimeError, match="forward-only"):
        K.fused_cgblock_pre(args[0].requires_grad_(), *args[1:], d=2)


def test_cgnet_predict_on_cuda_matches_cpu(cuda):
    """f32 predict of the full-depth CGNet through K4 (22 launches) and K1
    on the card == the CPU's predict through the plain versions, except
    at near-ties (rate <= 1e-4)."""
    model = build_model("cgnet", 19, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.RandomState(3)
                              .randn(2, 3, 128, 256).astype(np.float32))
    want = make_predict_step(model)(images)
    before = dict(K.LAUNCHES)
    with _counting_bn(model) as bn:
        got = make_predict_step(model.to(cuda))(images.to(cuda))
    torch.cuda.synchronize()
    launched = {k: K.LAUNCHES[k] - before[k] for k in before}
    assert launched == {"dsconv": 0, "resize_argmax": 1, "resize_ce_fwd": 0,
                        "resize_ce_bwd": 0, "cgblock": 22,
                        "resize_bilinear_bwd": 0, "adaptive_pool_bwd": 0,
                        "subpixel_argmax": 0, **bn}
    assert bn["bn_apply"] > 0 == bn["bn_moments"] == bn["bn_bwd"]
    assert got.shape == want.shape and got.dtype == torch.int32
    assert (got.cpu() != want).float().mean() <= 1e-4


# --- ENet's path: the index pool/unpool pair, predict, the CE + OHEM step ---

def _tied(seed, shape, dtype):
    """Random values with planted ties: a constant block, two values that
    alternate, and values that tie only once rounded to bf16."""
    x = torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                         .astype(np.float32))
    x[:, :, 2:6, 2:8] = 0.75
    x[:, :, 6:8, 0:4] = torch.tensor([[-1.0, 2.0, 2.0, -1.0],
                                      [2.0, 2.0, -3.0, 2.0]])
    x[:, :, 0:2, 8:10] = torch.tensor([[1.0, 1.001], [1.002, 0.999]])
    return x.to(dtype)


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("hw", [(16, 24), (17, 27)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_unpool_ties_on_cuda_match_cpu(cuda, dtype, hw, channels_last):
    """Values, indices (ties to the first window position) and the unpool,
    plain and with ``output_size``, and both gradients: bit for bit the
    CPU's, in either memory format."""
    from esn_tpu_torch.ops import pooling as P
    x = _tied(5, (2, 16, *hw), dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    g = torch.from_numpy(np.random.RandomState(6).randn(2, 16, *hw)
                         .astype(np.float32)).to(dtype)
    out = []
    for dev in ("cpu", cuda):
        xd = x.to(dev).detach().clone().requires_grad_()
        v, idx = P.max_pool2d_with_indices_2x2(xd)
        y = v.detach().clone().requires_grad_()
        u = P.max_unpool2d_2x2(y, idx, hw)
        (u * g.to(dev)).sum().backward()
        (v * y.grad).sum().backward()
        out.append((v, idx, u, P.max_unpool2d_2x2(v, idx), y.grad, xd.grad))
    assert bool((out[0][1][:, :, 1:3, 1:4] % 2 == 0).all())   # first column
    for a, b in zip(*out):
        assert a.dtype == b.dtype and torch.equal(a.detach(),
                                                  b.detach().cpu())


def _calibrated(arch="enet", seed=0, hw=(64, 128)):
    """``arch`` (19 classes) on the CPU from a seed, BN running statistics
    from one momentum-1 train pass (dropout off) over seeded images."""
    from esn_tpu_torch.nn import BatchNorm, Dropout
    model = build_model(arch, 19, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    for bn in bns:
        bn.momentum = 1.0
    calib = torch.from_numpy(np.random.RandomState(5)
                             .randn(2, 3, *hw).astype(np.float32))
    with torch.no_grad():
        model.train()(calib)
    for bn in bns:
        bn.momentum = 0.1
    return model.eval()


def test_enet_predict_and_eval_on_cuda_match_cpu(cuda):
    """f32 predict on the card == the CPU's except at near-ties (rate <=
    1e-4); K7 (its fused head) launches once, no other kernel; the eval
    step's
    confusion matrix differs by at most two entries a mismatched pixel."""
    import copy
    from esn_tpu_torch.train.step import make_eval_step
    cpu = _calibrated()
    gpu = copy.deepcopy(cpu).to(cuda)
    rng = np.random.RandomState(3)
    images = torch.from_numpy(rng.randn(2, 3, 64, 128).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 19, (2, 64, 128))
                              .astype(np.int32))
    labels[:, 30:34] = 255
    want = make_predict_step(cpu)(images)
    before = dict(K.LAUNCHES)
    with _counting_bn(gpu) as bn:
        got = make_predict_step(gpu)(images.to(cuda))
    assert K.LAUNCHES == {**before,
                          "subpixel_argmax": before["subpixel_argmax"] + 1,
                          "bn_apply": before["bn_apply"] + bn["bn_apply"]}
    assert bn["bn_apply"] > 0 == bn["bn_moments"] == bn["bn_bwd"]
    assert got.shape == want.shape and got.dtype == torch.int32
    assert len(torch.unique(want)) > 3
    mismatched = int((got.cpu() != want).sum())
    assert mismatched <= 1e-4 * want.numel()
    batch = {"image": images, "label": labels, "valid": 1}
    _, cm0 = make_eval_step(cpu, 19)(batch)
    pred, cm = make_eval_step(gpu, 19)(batch)     # moves the batch over
    assert pred.device.type == cm.device.type == "cuda"
    assert int(cm.sum()) == int((labels[:1] != 255).sum())
    assert int((cm.cpu() - cm0).abs().sum()) <= 2 * mismatched


@pytest.mark.parametrize("arch, hw, grad_rel", [("enet", (64, 128), 8e-2),
                                                ("fastscnn", (128, 256),
                                                 3e-2)])
def test_ce_ohem_train_step_on_cuda_matches_cpu(cuda, arch, hw, grad_rel):
    """One f32 step (adam + poly, class-weighted CE + OHEM on the
    full-resolution logits, ``fwd_method=None``, dropout off) on the card
    == the same step on the CPU: loss rel 1e-5; per-leaf gradient rel-L2
    <= ``grad_rel`` (+1e-6 abs): at this size the f32 gradient is
    ill-conditioned (ENet's moves by up to 1.6e-2 on the CPU when the
    batch's two images swap places and lies up to 3.9e-2 from an f64 run,
    tests/test_torch_enet_train.py; Fast-SCNN as the step test above);
    params within 2*lr; BN stats 1e-4; no kernel launches (OHEM takes the
    step off the fused resize-CE route). Read on an H100: at most
    2.1e-2 (ENet) and 1.9e-2 (Fast-SCNN); the pool's, the unpool's and
    the transposed conv's own backward are held to the CPU's by the tests
    above and below."""
    import copy
    from esn_tpu_torch.nn import Dropout
    from esn_tpu_torch.train import losses as L
    from esn_tpu_torch.train.optimizers import build_optimizer
    from esn_tpu_torch.train.schedules import build_schedule
    from esn_tpu_torch.train.step import make_train_step
    rng = np.random.RandomState(4)
    images = torch.from_numpy(rng.randn(2, 3, *hw).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 19, (2, *hw)).astype(np.int32))
    labels[:, hw[0] // 2 - 4:hw[0] // 2 + 4] = 255
    cw = torch.from_numpy((rng.rand(19) + 0.5).astype(np.float32))
    lr = 4.5e-4

    def loss_on(dev):
        w = cw.to(dev)
        return lambda logits, lab: (
            L.cross_entropy(logits, lab, num_classes=19, class_weights=w)
            + L.ohem_cross_entropy(logits, lab, num_classes=19))

    cpu = build_model(arch, 19, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    for m in cpu.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    assert L.fused_resize_ce_spec(cpu, "ohem") == (None, None)
    gpu = copy.deepcopy(cpu).to(cuda)
    losses = []
    before = dict(K.LAUNCHES)
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        step = make_train_step(
            model, loss_on(dev), build_optimizer("adam", model.parameters()),
            schedule=build_schedule("poly", lr, 100), fwd_method=None)
        with _counting_bn(model) as bn:
            losses.append(float(step({"image": images.to(dev),
                                      "label": labels.to(dev)})["loss"]))
    # no K1-K4 (the loss takes the full logits); K5 and K6 for each
    # upsample and adaptive pool back-propagated through on the card
    k5, k6 = {"enet": (0, 0), "fastscnn": (6, 4)}[arch]
    assert {k: K.LAUNCHES[k] - before[k] for k in before} == {
        "dsconv": 0, "resize_argmax": 0, "resize_ce_fwd": 0,
        "resize_ce_bwd": 0, "cgblock": 0, "resize_bilinear_bwd": k5,
        "adaptive_pool_bwd": k6, "subpixel_argmax": 0, **bn}
    want, got = losses
    assert abs(got - want) <= 1e-5 * abs(want)
    excess = {}
    for (name, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        g, g0 = q.grad.cpu(), p.grad
        d, n0 = float(torch.linalg.norm(g - g0)), float(torch.linalg.norm(g0))
        excess[name] = (d - grad_rel * n0 - 1e-6, d / max(n0, 1e-30))
        assert float((q.detach().cpu() - p.detach()).abs().max()) <= (
            2 * lr + 1e-7)
    worst = sorted(excess.items(), key=lambda kv: -kv[1][0])[:8]
    assert worst[0][1][0] <= 0, worst
    for (name, b), b2 in zip(cpu.named_buffers(), gpu.buffers()):
        torch.testing.assert_close(b2.cpu(), b, atol=1e-4, rtol=1e-4)


# launches of one predict (K2 dsconv, K1 resize_argmax, K7
# subpixel_argmax) and, where the
# card's and the CPU's class maps differ, how close the CPU's f32 logits
# of the two classes lie, relative to max(1, |logit|): twice the f32
# logit tolerance of the model's CPU parity test against the reference
# (tests/test_torch_contextnet.py, _erfnet_edanet.py, _segnet_linknet.py,
# _espnetv2_dabnet.py, _espnet.py, _lednet_esnet.py, _fpenet.py,
# _fssnet_sqnet_unet.py).
# SegNet is held by its mismatch rate alone: its pool indices may flip
# between the devices where two values of a window lie within f32
# rounding (chip_smoke.py's zoo phases hold it outside those windows'
# fields).
_K7 = {"dsconv": 0, "resize_argmax": 0, "subpixel_argmax": 1}
_K1 = {"dsconv": 0, "resize_argmax": 1, "subpixel_argmax": 0}
_NONE = {"dsconv": 0, "resize_argmax": 0, "subpixel_argmax": 0}
ZOO_PREDICT = {
    "contextnet": ({**_K1, "dsconv": 5}, 2e-4),
    "edanet": (_K1, 2e-4),
    "erfnet": (_K7, 4e-3),
    "segnet": (_NONE, None),
    "linknet": (_K7, 2e-4),
    "espnetv2": (_K1, 2e-4),
    "dabnet": (_K1, 2e-4),
    "espnet_c": (_K1, 2e-4),
    "espnet": (_K7, 2e-4),
    "lednet": (_K1, 4e-3),
    "esnet": (_K7, 2e-3),
    "fpenet": (_K1, 2e-4),
    "fssnet": (_K7, 2e-4),
    "sqnet": (_K7, 2e-4),
    "unet": (_NONE, 2e-4),
}


@pytest.mark.parametrize("arch", sorted(ZOO_PREDICT))
def test_zoo_predict_on_cuda_matches_cpu(cuda, arch):
    """f32 predict of the port's zoo at 2x3x64x128 on the card == the
    CPU's, except at near-ties (rate <= 1e-3); the kernels a predict
    launches (ContextNet: K2 x5 and K1; EDANet, ESPNetv2, DABNet, ESPNet-C,
    LEDNet and FPENet (r = 2): K1; ENet, ERFNet, LinkNet, ESPNet, ESNet,
    FSSNet and SQNet: K7; SegNet and UNet none)."""
    import copy
    launches, gap = ZOO_PREDICT[arch]
    cpu = _calibrated(arch)
    gpu = copy.deepcopy(cpu).to(cuda)
    images = torch.from_numpy(np.random.RandomState(3)
                              .randn(2, 3, 64, 128).astype(np.float32))
    want = make_predict_step(cpu)(images)
    before = dict(K.LAUNCHES)
    got = make_predict_step(gpu)(images.to(cuda)).cpu()
    torch.cuda.synchronize()
    assert {k: K.LAUNCHES[k] - before[k] for k in launches} == launches
    assert K.LAUNCHES["cgblock"] == before["cgblock"]
    assert got.shape == want.shape and got.dtype == torch.int32
    assert len(torch.unique(want)) > 3
    diff = got != want
    assert float(diff.float().mean()) <= 1e-3
    if gap is not None and bool(diff.any()):
        with torch.no_grad():
            logits = cpu(images).permute(0, 2, 3, 1)[diff]
        a = logits.gather(1, got[diff].long()[:, None])
        b = logits.gather(1, want[diff].long()[:, None])
        assert bool(((a - b).abs() <= gap * torch.clamp(b.abs(), min=1))
                    .all())


# K7, the subpixel class argmax of a final stride-2 transposed conv,
# against its plain version: where the two maps differ, the exact logits
# of the two classes lie within the gap rule (SA.gap_rule: f32 sums in
# other orders; in bf16 the plain version also rounds the phase logit and
# its sum with the bias). Both head geometries of the zoo (k2s2p0,
# k3s2p1op1), I in {16, 19, 32} (19: ESPNet's, no 16-byte loads), O in
# {11, 19}, bias or none, odd H and W (the phase-1 taps of k3s2p1op1 reach
# past the last row and column).
SA = importlib.import_module("esn_tpu_torch.ops.kernels.subpixel_argmax")
K7_GEOMETRIES = {"k2s2p0": (2, 0), "k3s2p1op1": (3, 1)}


def _k7_args(seed, shape, cout, k, bias, dtype, device):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa
    cin = shape[-1]
    return (t(rng.randn(*shape)).to(dtype),
            t(rng.randn(cin, cout, k, k) / np.sqrt(cin * k)),
            t(rng.randn(cout) * 0.1) if bias else None)


def _k7_check(x, w, b, p, got, want):
    diff = got != want
    if bool(diff.any()):
        gap, mag = SA.argmax_gap(x, w, b, got, want, stride=(2, 2),
                                 padding=(p, p))
        rule = SA.gap_rule(x.dtype, w, (2, 2), (p, p))
        assert bool((gap <= rule * mag)[diff].all())
    return int(diff.sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geometry", sorted(K7_GEOMETRIES))
@pytest.mark.parametrize("shape, cout, bias", [
    ((2, 37, 53, 16), 19, False),     # ENet's head, odd H and W
    ((2, 37, 53, 16), 11, True),      # ERFNet's, CamVid's classes
    ((2, 20, 33, 19), 19, False),     # ESPNet's I = 19
    ((1, 21, 30, 32), 19, True),      # SQNet's and LinkNet's I = 32
    ((1, 1, 1, 8), 5, True),          # one pixel, 5 classes
    ((2, 64, 128, 16), 19, True),     # FSSNet's head at 128x256
])
def test_subpixel_argmax_kernel_matches_plain(cuda, shape, cout, bias,
                                              geometry, dtype):
    k, p = K7_GEOMETRIES[geometry]
    x, w, b = _k7_args(4, shape, cout, k, bias, dtype, cuda)
    before = K.LAUNCHES["subpixel_argmax"]
    got = K.subpixel_argmax(x, w, b, stride=2, padding=p)
    torch.cuda.synchronize()
    assert K.LAUNCHES["subpixel_argmax"] == before + 1
    want = K.subpixel_argmax_ref(x, w, b, stride=2, padding=p)
    n, h, wd, _ = shape
    assert got.shape == want.shape == (n, 2 * h, 2 * wd)
    assert got.dtype == torch.int32
    mismatched = _k7_check(x, w, b, p, got, want)
    if dtype == torch.float32:
        assert mismatched <= 1 + 1e-4 * got.numel()
    assert torch.equal(got, K.subpixel_argmax(x, w, b, stride=2, padding=p))


# the bf16 route's tile edges (16 low-res columns by 16 rows, a halo for
# k3s2p1op1): H and W off the tile, W odd (4-byte stores) and even
# (16-byte ones), I in {8, 16, 19, 32, 48} (K padded to 16, 32 or 48; 19
# staged element by element) and O in {5, 11, 19, 32} (classes padded to
# 8, 16, 24 or 32); f32 at the same shapes
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geometry", sorted(K7_GEOMETRIES))
@pytest.mark.parametrize("shape, cout", [
    ((2, 45, 75, 8), 5),
    ((1, 33, 64, 48), 32),
    ((2, 17, 31, 16), 32),
    ((1, 19, 20, 19), 5),
    ((1, 16, 16, 32), 11),
    ((3, 7, 49, 48), 19),
])
def test_subpixel_argmax_kernel_tile_edges(cuda, shape, cout, geometry,
                                           dtype):
    k, p = K7_GEOMETRIES[geometry]
    x, w, b = _k7_args(8, shape, cout, k, True, dtype, cuda)
    got = K.subpixel_argmax(x, w, b, stride=2, padding=p)
    want = K.subpixel_argmax_ref(x, w, b, stride=2, padding=p)
    torch.cuda.synchronize()
    n, h, wd, _ = shape
    assert got.shape == want.shape == (n, 2 * h, 2 * wd)
    assert int(got.min()) >= 0 and int(got.max()) < cout
    mismatched = _k7_check(x, w, b, p, got, want)
    if dtype == torch.float32:
        assert mismatched <= 1 + 1e-4 * got.numel()
    else:
        assert mismatched <= 2e-2 * got.numel()


@pytest.mark.parametrize("geometry", sorted(K7_GEOMETRIES))
def test_subpixel_argmax_grid_does_not_change_the_map(cuda, geometry):
    """The bf16 route's persistent grid capped at 1, 3 and 7 blocks gives
    the uncapped grid's map bit for bit: each pixel is summed by one warp
    in one order, whichever block takes its tile."""
    k, p = K7_GEOMETRIES[geometry]
    x, w, b = _k7_args(9, (2, 37, 53, 16), 19, k, True, torch.bfloat16, cuda)
    want = K.subpixel_argmax(x, w, b, stride=2, padding=p)
    for cap in (1, 3, 7):
        assert torch.equal(SA._call(x, w, b, 2, p, max_blocks=cap), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_subpixel_argmax_kernel_takes_misaligned_x(cuda, dtype):
    """x one element off a 16-byte boundary: the element-by-element loads
    (bf16: the element-by-element staging), equal to an aligned copy's map
    bit for bit."""
    x, w, b = _k7_args(5, (2, 11, 17, 16), 19, 3, True, dtype, cuda)
    es, nbytes = x.element_size(), x.numel() * x.element_size()
    buf = torch.empty(nbytes + 16, dtype=torch.uint8, device=cuda)
    shifted = buf[es:es + nbytes].view(dtype).view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    assert torch.equal(K.subpixel_argmax(x, w, b, stride=2, padding=1),
                       K.subpixel_argmax(shifted, w, b, stride=2, padding=1))


def test_subpixel_argmax_first_max(cuda):
    """Classes 3 and 7 with the same weights and bias (100 above the rest)
    tie at every pixel; zero features tie every class (no bias): the
    first class wins, as the plain version's."""
    for dtype in (torch.float32, torch.bfloat16):
        x, w, b = _k7_args(6, (2, 9, 13, 16), 11, 3, True, dtype, cuda)
        w[:, 7] = w[:, 3]
        b.zero_()
        b[[3, 7]] = 100.0
        got = K.subpixel_argmax(x, w, b, stride=2, padding=1)
        assert bool((got == 3).all())
        got = K.subpixel_argmax(torch.zeros_like(x), w, None, stride=2,
                                padding=1)
        assert bool((got == 0).all())


def test_subpixel_argmax_wrapper_raises_on_cuda(cuda):
    x, w, b = _k7_args(7, (1, 4, 6, 16), 11, 2, True, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.subpixel_argmax(x.transpose(1, 2), w, b, stride=2, padding=0)
    with pytest.raises(TypeError, match="dtype"):
        K.subpixel_argmax(x.half(), w, b, stride=2, padding=0)
    with pytest.raises(ValueError, match="no kernel"):
        K.subpixel_argmax(x, torch.cat([w] * 4, 1), None, stride=2,
                          padding=0)                       # 44 classes
    with pytest.raises(ValueError, match="no kernel"):
        K.subpixel_argmax(x, w.repeat(1, 1, 2, 2)[:, :, :3, :3], b,
                          stride=3, padding=0)             # stride 3
    with pytest.raises(ValueError, match="device"):
        K.subpixel_argmax(x, w.cpu(), b, stride=2, padding=0)


@pytest.mark.parametrize("arch", ["enet", "espnet", "linknet"])
def test_head_predict_on_cuda_matches_cpu(cuda, arch):
    """f32 predict through K7 on the card == the CPU's (K7's plain
    version) but at near-ties (rate <= 1e-3); one K7 launch a predict and
    no other kernel but K8's apply, once a BatchNorm."""
    import copy
    cpu = _calibrated(arch)
    gpu = copy.deepcopy(cpu).to(cuda)
    images = torch.from_numpy(np.random.RandomState(3)
                              .randn(2, 3, 64, 128).astype(np.float32))
    want = make_predict_step(cpu)(images)
    before = dict(K.LAUNCHES)
    with _counting_bn(gpu) as bn:
        got = make_predict_step(gpu)(images.to(cuda)).cpu()
    launched = {k: v - before[k] for k, v in K.LAUNCHES.items()}
    assert launched == {**{k: 0 for k in launched}, "subpixel_argmax": 1,
                        **bn}
    assert bn["bn_apply"] > 0 == bn["bn_moments"] == bn["bn_bwd"]
    assert got.shape == want.shape and len(torch.unique(want)) > 3
    assert float((got != want).float().mean()) <= 1e-3


@pytest.mark.parametrize("shape, kernel, dilation", [
    ((2, 32, 24, 48), (3, 3), (2, 2)), ((2, 32, 24, 48), (3, 3), (4, 4)),
    ((2, 32, 24, 48), (3, 1), (2, 1)), ((2, 16, 48, 96), (3, 3), (8, 8)),
    ((2, 64, 96, 192), (3, 1), (4, 1))])
def test_depthwise_bf16_gradients_on_cuda_match_f64(cuda, shape, kernel,
                                                    dilation):
    """A bf16 depthwise conv with a row dilation above 1, in channels_last
    (a ``Conv`` moved to channels_last, as ``build_model`` leaves a
    model's): dW, dx and the output within 1e-2 (rel-max) of an f64 run on
    the card, the bf16 output channels_last. On the CPU torch's dW is wrong
    there (tests/test_torch_conv_bf16_dw.py); this holds the card's route,
    which the port leaves as it is."""
    import copy
    from esn_tpu_torch.nn import Conv
    gen = torch.Generator().manual_seed(0)
    pad = tuple(d * (k // 2) for k, d in zip(kernel, dilation))
    conv = Conv(shape[1], shape[1], kernel, padding=pad, dilation=dilation,
                groups=shape[1], bias=False)
    conv.reset_parameters(gen)
    x = torch.randn(shape, generator=gen)
    go = torch.randn(shape, generator=gen)
    out = {}
    for dtype in (torch.float64, torch.bfloat16):
        m = copy.deepcopy(conv).to(
            device=cuda, memory_format=torch.channels_last,
            dtype=torch.float64 if dtype == torch.float64 else torch.float32)
        xx = x.to(device=cuda, dtype=dtype).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        y = m(xx)
        y.backward(go.to(device=cuda, dtype=dtype).contiguous(
            memory_format=torch.channels_last))
        out[dtype] = (y.detach().double(), xx.grad.double(),
                      m.weight.grad.double())
        # (the f64 reference conv answers in NCHW on the card)
        assert y.is_contiguous(memory_format=torch.channels_last) or (
            dtype == torch.float64)
    for got, want in zip(out[torch.bfloat16], out[torch.float64]):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-2


def test_conv_transpose_on_cuda_matches_cpu(cuda):
    """ENet's three transposed convs' geometry (3x3, stride 2, padding 1,
    output_padding 1) with an asymmetric kernel, f32: output and both
    gradients within 1e-5 of the CPU's."""
    from esn_tpu_torch.nn import ConvTranspose
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 16, 9, 13).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 19, 18, 26).astype(np.float32))
    layer = ConvTranspose(16, 19, 3, stride=2, padding=1, output_padding=1,
                          bias=False)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    out = []
    for dev in ("cpu", cuda):
        m = ConvTranspose(16, 19, 3, stride=2, padding=1, output_padding=1,
                          bias=False).to(dev)
        m.load_state_dict(layer.state_dict())
        xd = x.to(dev).detach().clone().requires_grad_()
        y = m(xd)
        (y * g.to(dev)).sum().backward()
        out.append((y.detach().cpu(), xd.grad.cpu(), m.weight.grad.cpu()))
    assert tuple(out[0][0].shape) == (2, 19, 18, 26)
    for a, b in zip(*out):
        torch.testing.assert_close(b, a, atol=1e-5, rtol=1e-5)


def test_load_encoder_into_a_model_on_the_card(cuda, tmp_path):
    """``load_encoder`` of an ESPNet-C checkpoint (saved from the CPU) into
    an ESPNet on the card: the encoder's leaves equal the donor's bit for
    bit, on the card; an f32 forward then matches the CPU's grafted
    model's within 1e-4 (relative to max(1, |logit|))."""
    import copy
    from esn_tpu_torch.train import checkpoint as ckpt
    from esn_tpu_torch.train.optimizers import build_optimizer
    from esn_tpu_torch.train.state import TrainState
    donor = _calibrated("espnet_c", seed=3)
    path = ckpt.save_checkpoint(str(tmp_path), 1, TrainState(
        donor, build_optimizer("adam", donor.parameters())))
    cpu = build_model("espnet", 19, device="cpu")
    gpu = copy.deepcopy(cpu).to(cuda)
    for model in (cpu, gpu):
        ckpt.load_encoder(path, model)
    want = donor.state_dict()
    for key, value in gpu.enc.state_dict().items():
        assert value.device.type == "cuda"
        assert torch.equal(value.cpu(), want[key]), key
    images = torch.from_numpy(np.random.RandomState(2)
                              .randn(2, 3, 64, 128).astype(np.float32))
    with torch.no_grad():
        a = cpu.eval()(images)
        b = gpu.eval()(images.to(cuda)).cpu()
    assert bool(((a - b).abs() <= 1e-4 * torch.clamp(a.abs(), min=1)).all())


# focal and the Lovász losses on the card against the CPU, f32: the value
# within 1e-5 relative, the gradient with respect to the logits within
# these rel-L2 bounds: softmax, exp and log in other orders (~1e-7); for
# lovasz the order of pixels whose errors the two devices round apart,
# for lovasz_hist the key of a pixel whose error they round across a
# bucket's edge (chip_smoke.py's LOSS_CPU_GRAD_REL, read there on a slice
# of Fast-SCNN's logits: 1.5e-7, 9.2e-5, 2.4e-3)
NEW_LOSS_GRAD_REL = {"focal": 1e-5, "lovasz": 1e-3, "lovasz_hist": 1e-2}


@pytest.mark.parametrize("name", sorted(NEW_LOSS_GRAD_REL))
@pytest.mark.parametrize("ignore_all", [False, True])
def test_new_losses_on_cuda_match_cpu(cuda, name, ignore_all):
    from esn_tpu_torch.train import losses as L
    rng = np.random.RandomState(7)
    z = torch.from_numpy((rng.randn(2, 64, 128, 19) * 2).astype(np.float32))
    lab = torch.from_numpy(rng.randint(0, 20, (2, 64, 128)).astype(np.int32))
    lab[lab == 19] = 255
    if ignore_all:
        lab[:] = 255
    cw = torch.from_numpy((rng.rand(19) + 0.5).astype(np.float32))
    runs = []
    for dev in ("cpu", cuda):
        zz = z.to(dev).detach().clone().requires_grad_()
        loss = L.build_loss(name)(zz, lab.to(dev), num_classes=19,
                                  class_weights=cw.to(dev))
        loss.backward()
        runs.append((float(loss.detach()), zz.grad.cpu()))
    (v0, g0), (v, g) = runs
    assert abs(v - v0) <= 1e-5 * abs(v0)
    if ignore_all:
        assert not g.any() and not g0.any()
    else:
        assert float((g - g0).norm() / g0.norm()) <= NEW_LOSS_GRAD_REL[name]


@pytest.mark.parametrize("name", ["radam", "ranger"])
def test_radam_ranger_on_cuda_match_cpu(cuda, name):
    """14 steps of the same seeded gradients, weight decay and a learning
    rate that changes every step, on the card and on the CPU: each
    parameter within 16 f32 ulps of its largest value (the same formulas in
    f32; an FMA here or there), Lookahead's slow weights too."""
    from esn_tpu_torch.train.optimizers import build_optimizer
    rng = np.random.RandomState(8)
    shapes = [(64, 32, 3, 3), (32,), (19, 32, 1, 1)]
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(14)]
    runs = []
    for dev in ("cpu", cuda):
        params = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(dev))
                  for a in p0]
        opt = build_optimizer(name, params, weight_decay=1e-2)
        for t, g in enumerate(grads):
            for p, a in zip(params, g):
                p.grad = torch.from_numpy(a).to(dev)
            for group in opt.param_groups:
                group["lr"] = 1e-2 * (1 + 0.1 * t)
            opt.step()
        runs.append((params, opt))
    (cpu_p, cpu_opt), (gpu_p, gpu_opt) = runs
    for a, b in zip(cpu_p, gpu_p):
        assert float((b.detach().cpu() - a.detach()).abs().max()) <= (
            2.0 ** -20 * float(a.detach().abs().max()))
        if name == "ranger":
            sa, sb = cpu_opt.state[a]["slow"], gpu_opt.state[b]["slow"]
            assert float((sb.cpu() - sa).abs().max()) <= (
                2.0 ** -20 * float(sa.abs().max()))


@pytest.mark.parametrize("loss_name", ["ce", "lovasz"])
def test_remat_step_on_cuda_matches_the_step_without(cuda, loss_name):
    """A Fast-SCNN f32 step with remat on the card against the same step
    without (dropout on, the same seed): the loss and the BN running
    statistics bit for bit (the first forward is the same, the recompute
    moves no statistic), the gradients of all parameters together within
    4x the gap of a second step without remat plus 1e-6 (K5 and K6 sum the
    upsamples' and pools' backward in one order, but cuDNN's f32 weight
    gradients differ run to run with its deterministic flag off); K3 once
    forward and once backward with the weighted-CE loss either way, K5 5
    (6 on the full logits) and K6 4 times; K8 once a BatchNorm each way,
    and under remat its forward (moments, apply) again in the recompute."""
    import copy
    from functools import partial
    from esn_tpu_torch.train import losses as L
    from esn_tpu_torch.train.optimizers import build_optimizer
    from esn_tpu_torch.train.step import make_train_step
    rng = np.random.RandomState(9)
    images = torch.from_numpy(rng.randn(2, 3, 128, 256).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 19, (2, 128, 256))
                              .astype(np.int32)).to(cuda)
    model0 = build_model("fastscnn", 19, device=cuda,
                         generator=torch.Generator().manual_seed(0))
    runs = {}
    for which in ("plain", "remat", "again"):
        model = copy.deepcopy(model0)
        fused, method = L.fused_resize_ce_spec(model, loss_name)
        step = make_train_step(
            model, partial(fused or L.build_loss(loss_name), num_classes=19),
            build_optimizer("adam", model.parameters()), fwd_method=method,
            remat=which == "remat",
            generator=torch.Generator(device=cuda).manual_seed(3))
        before = dict(K.LAUNCHES)
        loss = float(step({"image": images.to(cuda), "label": labels})
                     ["loss"])
        launched = {k: K.LAUNCHES[k] - before[k] for k in before}
        runs[which] = (loss, launched,
                       torch.cat([p.grad.flatten()
                                  for p in model.parameters()]),
                       [b.clone() for b in model.buffers()])
    (loss, launched, g, stats) = runs["plain"]
    (loss_r, launched_r, g_r, stats_r) = runs["remat"]
    g_again = runs["again"][2]
    assert loss_r == loss
    assert all(torch.equal(a, b) for a, b in zip(stats, stats_r))
    k3 = 1 if loss_name == "ce" else 0
    bn_keys = ("bn_moments", "bn_apply", "bn_bwd")
    others = [{k: v for k, v in d.items() if k not in bn_keys}
              for d in (launched_r, launched)]
    assert others[0] == others[1] == {"dsconv": 0, "resize_argmax": 0,
                                      "resize_ce_fwd": k3,
                                      "resize_ce_bwd": k3, "cgblock": 0,
                                      "resize_bilinear_bwd": 6 - k3,
                                      "adaptive_pool_bwd": 4,
                                      "subpixel_argmax": 0}
    # K8: a BatchNorm a forward each way, and the recompute's forward again
    from esn_tpu_torch.nn import BatchNorm
    n_bn = sum(isinstance(m, BatchNorm) for m in model0.modules())
    assert [launched[k] for k in bn_keys] == [n_bn] * 3
    assert [launched_r[k] for k in bn_keys] == [2 * n_bn, 2 * n_bn, n_bn]
    gap = float((g_r - g).norm() / g.norm())
    noise = float((g_again - g).norm() / g.norm())
    assert gap <= 4 * noise + 1e-6, (gap, noise)


def test_two_rank_step_on_cuda_matches_one_process(cuda):
    """Two ranks on the card under gloo (the backend rule, with one card)
    take the global-batch weighted-CE step of Fast-SCNN-19 through K3,
    1 + 1 launches a rank, against one process on the same batch, f32
    (TF32 off): the loss within 1e-5, the summed gradient within 1e-3
    (rel-L2; the BN and loss sums split over the ranks, and the card's
    atomics), the BN statistics within 1e-5."""
    import _torch_parallel as TP
    from esn_tpu_torch.parallel import launch
    rng = np.random.RandomState(4)
    images = rng.randn(4, 3, 128, 256).astype(np.float32)
    labels = rng.randint(0, 19, (4, 128, 256)).astype(np.int32)
    one = TP.cuda_step_case(images, labels)
    ranks = launch.run_ranks(TP.cuda_step_case, 2, images, labels,
                             device="cuda", timeout=300.0, threads=None)
    for r in ranks:
        assert r["launches"]["resize_ce_fwd"] == 1
        assert r["launches"]["resize_ce_bwd"] == 1
        assert abs(float(r["loss"]) - float(one["loss"])) \
            <= 1e-5 * abs(float(one["loss"]))
        assert np.linalg.norm(r["grads"] - one["grads"]) \
            <= 1e-3 * np.linalg.norm(one["grads"])
        np.testing.assert_allclose(r["stats"], one["stats"], rtol=1e-5,
                                   atol=1e-5)
    launch.assert_ranks_equal([r["stats"] for r in ranks])


# ------------------------------------------------------------ K8: BatchNorm
# The BNs of the cells (C, H, W): Fast-SCNN's from the learning-to-
# downsample stem to its first bottleneck's expansion, CGNet's 35- and
# 131-channel inputs of stages 2 and 3, at b8
BN_SHAPES = [(32, 512, 1024), (48, 256, 512), (64, 128, 256),
             (384, 128, 256), (35, 512, 1024), (131, 256, 512)]


def _bn_inputs(seed, shape, dtype, channels_last, device):
    """x and dy (8, *shape) in ``dtype`` and the layout; weight, bias and
    running statistics in the accumulation type."""
    gen = torch.Generator(device=device).manual_seed(seed)
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    c = shape[0]

    def draw(*s):
        return torch.randn(s, generator=gen, device=device, dtype=acc)

    x = (draw(8, *shape) * 2 + 0.5).to(dtype).contiguous(memory_format=fmt)
    dy = draw(8, *shape).to(dtype).contiguous(memory_format=fmt)
    return (x, dy, draw(c).abs() + 0.5, draw(c) * 0.1, draw(c) * 0.3,
            draw(c).abs() + 0.5)


def _bn_close(got, want, dtype):
    """Two f32 (f64) per-channel results summed in other orders."""
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * float(
        want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_batchnorm_kernels_match_plain(cuda, shape, channels_last, dtype):
    """K8's three wrappers against their plain versions at the cells'
    shapes: the statistics and the running statistics they move, the
    apply (bf16: at most one bf16 step from the plain version, which
    rounds where the kernel does; f32, f64: within an ulp or two), the
    backward's dx, dweight and dbias; each launch counted once, and the
    reductions twice on the same inputs give the same bits."""
    x, dy, w, b, rm, rv = _bn_inputs(0, shape, dtype, channels_last, cuda)
    n = x.numel() // shape[0]
    kw = dict(n=n, unbias=n / (n - 1), momentum=0.1, update=True)
    before = dict(K.LAUNCHES)
    rm_k, rv_k, rm_p, rv_p = rm.clone(), rv.clone(), rm.clone(), rv.clone()
    stats = K.bn_moments(x, rm, rm_k, rv_k, **kw)
    want = K.bn_moments_ref(x, rm, rm_p, rv_p, **kw)
    for got_t, want_t in ((stats, want), (rm_k, rm_p), (rv_k, rv_p)):
        _bn_close(got_t, want_t, dtype)
    again = K.bn_moments(x, rm, rm.clone(), rv.clone(), **kw)
    assert torch.equal(stats, again)

    y = K.bn_apply(x, want[0], want[1], w, b, 1e-5)
    y_want = K.bn_apply_ref(x, want[0], want[1], w, b, 1e-5)
    assert y.dtype == dtype and y.stride() == x.stride()
    if dtype == torch.bfloat16:
        differ, far = K.bf16_step_gap(y, y_want)
        assert far == 0 and differ <= 1e-4 * y.numel(), (differ, far)
    else:
        _bn_close(y, y_want, dtype)

    got = K.bn_backward(dy, x, want[0], want[1], w, 1e-5, n=n,
                        batch_stats=True)
    ref = K.bn_backward_ref(dy, x, want[0], want[1], w, 1e-5, n=n,
                            batch_stats=True)
    assert got[0].stride() == x.stride()
    if dtype == torch.bfloat16:
        assert K.bf16_step_gap(got[0], ref[0])[1] == 0
    else:
        _bn_close(got[0], ref[0], dtype)
    for g, r in zip(got[1:], ref[1:]):
        _bn_close(g, r, dtype)
    again = K.bn_backward(dy, x, want[0], want[1], w, 1e-5, n=n,
                          batch_stats=True)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert {k: K.LAUNCHES[k] - before[k] for k in
            ("bn_moments", "bn_apply", "bn_bwd")} == {
        "bn_moments": 2, "bn_apply": 1, "bn_bwd": 2}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 35, 7, 5), (3, 131, 3, 1),
                                   (2, 19, 9, 11), (5, 8, 1, 1),
                                   (2, 3, 17, 13), (2, 16, 0, 8)])
def test_batchnorm_kernels_at_ragged_shapes(cuda, shape, dtype):
    """Tensors whose element count leaves a ragged last tile, a single
    pixel, odd planes (one element a load), an empty shard; misaligned,
    channel-sliced and NCHW inputs: the Function forward and backward
    against the plain route."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    n, c, h, w = shape
    base = torch.randn((n, c + 1, h, w), generator=gen, device=cuda)
    base = base.to(dtype).contiguous(memory_format=torch.channels_last)
    params = [torch.rand(c, generator=gen, device=cuda) + 0.5,
              torch.randn(c, generator=gen, device=cuda) * 0.1]
    views = {"sliced": base[:, 1:],
             "nchw": base[:, 1:].contiguous(),
             "misaligned": torch.empty(base[:, 1:].numel() + 1, dtype=dtype,
                                       device=cuda)[1:].view(n, h, w, c)
             .permute(0, 3, 1, 2)}
    views["misaligned"].copy_(base[:, 1:])
    count = max(n * h * w, 2)
    for name, x in views.items():
        outs = []
        for route in ("kernels", "plain"):
            t = x.detach().clone().requires_grad_()
            wt, bt = (p.clone().requires_grad_() for p in params)
            rm, rv = torch.zeros(c, device=cuda), torch.ones(c, device=cuda)
            fn = K.BatchNormFn.apply
            if route == "plain":
                t = t.cpu().detach().requires_grad_()
                wt, bt = (p.cpu().requires_grad_() for p in params)
                rm, rv = rm.cpu(), rv.cpu()
            y = fn(t, wt, bt, rm, rv, rm.clone(), 1e-5, 0.1,
                   (count, count / (count - 1)), True, None)
            y.float().square().sum().backward()
            outs.append([v.detach().float().cpu() for v in
                         (y, t.grad, wt.grad, bt.grad, rm, rv)])
        for got, want in zip(*outs):
            torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2,
                                       msg=name)


def test_batchnorm_module_routes_every_cuda_tensor(cuda):
    """A CUDA tensor takes K8 in training (moments, apply, backward) and in
    eval (apply; under a gradient the Function); the composite path is
    not entered."""
    from esn_tpu_torch.nn import BatchNorm
    bn = BatchNorm(24).to(cuda)
    x = torch.randn(2, 24, 16, 16, device=cuda).contiguous(
        memory_format=torch.channels_last).requires_grad_()

    def no_composite(*a):
        raise AssertionError("the composite path ran on a CUDA tensor")

    bn._normalise = no_composite
    before = dict(K.LAUNCHES)
    bn(x).sum().backward()
    bn.eval()
    with torch.no_grad():
        bn(x)
    bn(x).sum().backward()
    assert {k: K.LAUNCHES[k] - before[k] for k in
            ("bn_moments", "bn_apply", "bn_bwd")} == {
        "bn_moments": 1, "bn_apply": 3, "bn_bwd": 2}


def test_batchnorm_train_step_repeats_bit_for_bit(cuda):
    """One bf16 Fast-SCNN train step, twice from the same state on the same
    batch (cuDNN deterministic): every gradient and running statistic
    equal bit for bit; K8 launched once a BatchNorm each way."""
    import copy
    from functools import partial
    from esn_tpu_torch.nn import BatchNorm
    from esn_tpu_torch.train import losses as L
    from esn_tpu_torch.train.optimizers import build_optimizer
    from esn_tpu_torch.train.step import make_train_step
    rng = np.random.RandomState(5)
    images = torch.from_numpy(rng.randn(2, 3, 128, 256).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 19, (2, 128, 256))
                              .astype(np.int32)).to(cuda)
    model0 = build_model("fastscnn", 19, device=cuda,
                         generator=torch.Generator().manual_seed(0))
    n_bn = sum(isinstance(m, BatchNorm) for m in model0.modules())
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for _ in range(2):
            model = copy.deepcopy(model0)
            fused, method = L.fused_resize_ce_spec(model, "ce")
            step = make_train_step(
                model, partial(fused, num_classes=19),
                build_optimizer("adam", model.parameters()),
                fwd_method=method, compute_dtype=torch.bfloat16,
                generator=torch.Generator(device=cuda).manual_seed(3))
            before = dict(K.LAUNCHES)
            step({"image": images.to(cuda), "label": labels})
            torch.cuda.synchronize()
            runs.append(([p.grad.clone() for p in model.parameters()],
                         [b.clone() for b in model.buffers()],
                         {k: K.LAUNCHES[k] - before[k] for k in
                          ("bn_moments", "bn_apply", "bn_bwd")}))
    finally:
        torch.backends.cudnn.deterministic = det
    (g1, s1, l1), (g2, s2, l2) = runs
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))
    assert l1 == l2 == {"bn_moments": n_bn, "bn_apply": n_bn, "bn_bwd": n_bn}


def test_batchnorm_two_ranks_on_cuda_keep_equal_statistics(cuda):
    """Two ranks on the card under gloo through K8 (the world sums of the
    moments and of the backward's sums): the running statistics and the
    all-reduced affine gradients equal on both ranks, and each rank's y
    and dx within f32 rounding of one process on the whole batch."""
    import _torch_parallel as TP
    from esn_tpu_torch.parallel import launch
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 35, 24, 40) * 2 + 1).astype(np.float32)
    cot = rng.randn(4, 35, 24, 40).astype(np.float32)
    params = {"weight": rng.uniform(0.5, 1.5, 35).astype(np.float32),
              "bias": (rng.randn(35) * 0.1).astype(np.float32),
              "running_mean": (rng.randn(35) * 0.5).astype(np.float32),
              "running_var": rng.uniform(0.5, 1.5, 35).astype(np.float32)}
    one = TP.bn_case(x, cot, params, "float32", "kernels", "cuda")
    ranks = launch.run_ranks(TP.bn_case, 2, x, cot, params, "float32",
                             "kernels", "cuda", device="cuda", timeout=300.0,
                             threads=None)
    keys = ("dweight", "dbias", "running_mean", "running_var")
    launch.assert_ranks_equal([{k: r[k] for k in keys} for r in ranks])
    for i, r in enumerate(ranks):
        for k in ("y", "dx"):
            np.testing.assert_allclose(r[k], one[k][2 * i:2 * i + 2],
                                       rtol=1e-4, atol=1e-4)
        for k in keys:
            np.testing.assert_allclose(r[k], one[k], rtol=1e-4, atol=1e-5)
