"""K5 and K6, the fixed-order backward of the bilinear resize and of the
adaptive average pool (``esn_tpu_torch/ops/kernels/resize_bilinear_bwd.py``,
``adaptive_pool_bwd.py``), on the CPU: their plain versions, which the
kernels are held to on the card.

- against ``jax.vjp`` of the reference's ``esn_tpu.ops.resize
  .resize_bilinear`` and ``esn_tpu.ops.pooling.adaptive_avg_pool2d`` in
  f64, within TOL (1e-12) of the largest |gradient|, at every ratio the
  models use: x2, x4, x8, PPM's 1/2/3/6-bin maps up to the 1/32 map,
  CamVid's 45-row stages (and their 23- and 22-row neighbours), the
  downscales, and the ratio route of ``ops/resize.py::_interpolate``
  where its map is the size route's (the reference resizes by size). The
  reference's adaptive pool sums in f32 whatever x's dtype: it runs here
  with its ``jnp.float32`` read as f64 (test-side only);
- against torch's own autograd, through ``BilinearResize`` and
  ``AdaptiveAvgPool``, f64 within TOL, NCHW and channels_last, the ratio
  route too, and in f32 and bf16 (one rounding of the f32 sum);
- through ``_ShardedResize`` over uneven shards: the spatial cases of
  ``tests/_torch_spatial.py`` on 2, 3 and 4 gloo ranks with the K5/K6
  route forced on the CPU, against the whole tensor with torch's backward;
- planted faults (a tap index off by one, a wrong edge clamp, a
  weight rounded otherwise, a bin end off by one) break the bounds.
"""
import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import _torch_resize_bwd as TR
import _torch_spatial as TS
from esn_tpu.ops import pooling as JP
from esn_tpu.ops import resize as JR
from esn_tpu_torch.ops import kernels as K
from esn_tpu_torch.ops import pooling as P
from esn_tpu_torch.ops import resize as R
from esn_tpu_torch.parallel import launch

# the modules (the package's names of the same spelling are the wrappers)
KP = importlib.import_module("esn_tpu_torch.ops.kernels.adaptive_pool_bwd")
KR = importlib.import_module("esn_tpu_torch.ops.kernels.resize_bilinear_bwd")

TOL = 1e-12
N, C = 2, 3
# (input (H, W), output (H, W)): x2, x4, x8 (Fast-SCNN's fusion and
# tails), PPM's bins up to a 1/32 map (Cityscapes' 32x64 cut to 16x32,
# CamVid's 23x30), CamVid's 45-row stages, and downscales (ContextNet's
# image quarter, the 1/2 of a 45-row map)
RESIZES = {
    "x2": ((8, 12), (16, 24)), "x4": ((8, 12), (32, 48)),
    "x8": ((4, 6), (32, 48)),
    **{f"ppm{b}_to_16x32": ((b, b), (16, 32)) for b in (1, 2, 3, 6)},
    **{f"ppm{b}_to_23x30": ((b, b), (23, 30)) for b in (1, 2, 3, 6)},
    "camvid_45_to_90": ((45, 60), (90, 120)),
    "camvid_23_to_45": ((23, 30), (45, 60)),
    "camvid_90_to_180": ((90, 120), (180, 240)),
    "quarter_90_to_22": ((90, 120), (22, 30)),
    "half_45_to_22": ((45, 60), (22, 30)),
    "odd_13x17_to_29x11": ((13, 17), (29, 11)),
}
# the ratio route (scale factors) where the reference's size route
# gives the same map: (input (H, W), (sh, sw))
RATIOS = {"ratio_x2": ((13, 8), (2.0, 2.0)),
          "ratio_x8": ((3, 5), (8.0, 8.0)),
          "ratio_quarter": ((16, 8), (0.25, 0.5))}
# ratios whose map differs from any size route's: torch's autograd only
ODD_RATIOS = {"ratio_quarter_of_13": ((13, 8), (0.25, 0.5)),
              "ratio_3_of_5": ((5, 7), (3.0, 1.5))}
POOLS = {"pool1_32x64": ((32, 64), 1), "pool2_32x64": ((32, 64), 2),
         "pool3_32x64": ((32, 64), 3), "pool6_32x64": ((32, 64), 6),
         "pool3_23x30": ((23, 30), 3), "pool6_23x30": ((23, 30), 6),
         "pool6_5x7": ((5, 7), 6), "pool_2x3_13x17": ((13, 17), (2, 3))}


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _rand(seed, shape):
    return np.random.RandomState(seed).randn(*shape)


def _nhwc(a):
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1))


def _nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)


def _resize_vjp(x, out_hw, g):
    """The reference's input gradient of its resize, NCHW numpy in f64."""
    _, vjp = jax.vjp(lambda t: JR.resize_bilinear(t, out_hw),
                     jnp.asarray(_nhwc(x)))
    return _nchw(vjp(jnp.asarray(_nhwc(g)))[0])


class _JnpWide:
    """``jnp`` with ``float32`` read as ``float64``: the reference's pool,
    which sums in f32, in f64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _pool_vjp(x, bins, g, monkeypatch):
    monkeypatch.setattr(JP, "jnp", _JnpWide())
    _, vjp = jax.vjp(lambda t: JP.adaptive_avg_pool2d(t, bins),
                     jnp.asarray(_nhwc(x)))
    return _nchw(vjp(jnp.asarray(_nhwc(g)))[0])


def _resize_case(name, seed=0):
    (h, w), (oh, ow) = RESIZES[name]
    return _rand(seed, (N, C, h, w)), _rand(seed + 1, (N, C, oh, ow))


# ------------------------------------------------------ against the reference
@pytest.mark.parametrize("name", list(RESIZES))
def test_resize_backward_plain_matches_reference_vjp_f64(name, x64):
    x, g = _resize_case(name)
    want = _resize_vjp(x, g.shape[2:], g)
    got = K.resize_bilinear_bwd_ref(torch.from_numpy(g), x.shape[2:])
    assert got.dtype == torch.float64
    _close(got.numpy(), want, name)


@pytest.mark.parametrize("name", list(RATIOS))
def test_ratio_route_plain_matches_reference_vjp_f64(name, x64):
    (h, w), scales = RATIOS[name]
    oh, ow = int(h * scales[0]), int(w * scales[1])
    x, g = _rand(3, (N, C, h, w)), _rand(4, (N, C, oh, ow))
    want = _resize_vjp(x, (oh, ow), g)
    got = K.resize_bilinear_bwd_ref(torch.from_numpy(g), (h, w), scales)
    _close(got.numpy(), want, name)


@pytest.mark.parametrize("name", list(POOLS))
def test_pool_backward_plain_matches_reference_vjp_f64(name, x64,
                                                       monkeypatch):
    (h, w), bins = POOLS[name]
    oh, ow = (bins, bins) if isinstance(bins, int) else bins
    x, g = _rand(5, (N, C, h, w)), _rand(6, (N, C, oh, ow))
    want = _pool_vjp(x, bins, g, monkeypatch)
    got = K.adaptive_pool_bwd_ref(torch.from_numpy(g), (h, w))
    _close(got.numpy(), want, name)


# --------------------------------------------------- against torch's autograd
def _torch_grad(fn, x, g):
    t = x.detach().clone().requires_grad_()
    fn(t).backward(g)
    return t.grad


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "nhwc"])
@pytest.mark.parametrize("name", list(RESIZES) + list(RATIOS)
                         + list(ODD_RATIOS))
def test_resize_function_matches_torch_autograd_f64(name, channels_last):
    if name in RESIZES:
        x, _ = _resize_case(name, 7)
        size, scales = RESIZES[name][1], None
    else:
        (h, w), scales = {**RATIOS, **ODD_RATIOS}[name]
        x, size = _rand(7, (N, C, h, w)), None
    x = torch.from_numpy(x)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)

    def plain(t):
        return F.interpolate(t, size=size, scale_factor=scales,
                             mode="bilinear", align_corners=False,
                             antialias=False,
                             recompute_scale_factor=False if scales else None)

    y = plain(x)
    g = torch.from_numpy(_rand(8, tuple(y.shape)))
    if channels_last:
        g = g.contiguous(memory_format=torch.channels_last)
    t = x.detach().clone().requires_grad_()
    out = K.BilinearResize.apply(t, size, scales)
    assert torch.equal(out, y)              # the forward is F.interpolate
    out.backward(g)
    assert t.grad.is_contiguous(
        memory_format=torch.channels_last if channels_last
        else torch.contiguous_format)
    _close(t.grad.numpy(), _torch_grad(plain, x, g).numpy(), name)


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "nhwc"])
@pytest.mark.parametrize("name", list(POOLS))
def test_pool_function_matches_torch_autograd_f64(name, channels_last):
    (h, w), bins = POOLS[name]
    x = torch.from_numpy(_rand(9, (N, C, h, w)))
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    y = F.adaptive_avg_pool2d(x, bins)
    g = torch.from_numpy(_rand(10, tuple(y.shape)))
    t = x.detach().clone().requires_grad_()
    out = K.AdaptiveAvgPool.apply(t, bins)
    assert torch.equal(out, y)
    out.backward(g)
    want = _torch_grad(lambda u: F.adaptive_avg_pool2d(u, bins), x, g)
    _close(t.grad.numpy(), want.numpy(), name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["resize", "pool"])
def test_low_precision_rounds_the_f32_sum_once(which, dtype):
    """f32 and bf16 gradients: the f32 sum (the f64 sum's terms in f32)
    rounded once to g's dtype; f32 within 2^-20 of the f64 result's
    magnitude, bf16 within one bf16 step of the f32 result."""
    if which == "resize":
        g64 = torch.from_numpy(_rand(11, (N, C, 32, 48)))
        run = (lambda g: K.resize_bilinear_bwd_ref(g, (4, 6)))
    else:
        g64 = torch.from_numpy(_rand(11, (N, C, 6, 6)))
        run = (lambda g: K.adaptive_pool_bwd_ref(g, (23, 30)))
    want = run(g64)
    g32 = g64.to(dtype)
    got = run(g32)
    assert got.dtype == dtype
    if dtype == torch.float32:
        err = float((got.double() - want).abs().max())
        assert err <= 2.0 ** -20 * float(want.abs().max())
    else:
        f32 = run(g32.float())
        assert torch.equal(got, f32.to(torch.bfloat16))


# --------------------------------------------------- routing and the wrappers
def test_cpu_tensors_keep_torchs_backward_and_launch_nothing():
    before = dict(K.LAUNCHES)
    x = torch.randn(1, 2, 4, 6, requires_grad=True)
    y = R.resize_bilinear(x, (8, 12))
    p = P.adaptive_avg_pool2d(x, 2)
    assert "UpsampleBilinear2D" in type(y.grad_fn).__name__
    assert "AdaptiveAvgPool2D" in type(p.grad_fn).__name__
    (y.sum() + p.sum()).backward()
    assert not K.kernel_backward(x)
    assert K.LAUNCHES == before
    assert {"resize_bilinear_bwd", "adaptive_pool_bwd"} <= set(K.LAUNCHES)


def test_the_card_route_goes_through_the_functions(monkeypatch):
    """With the route forced, ``resize_bilinear`` (both routes), the
    replicated branch and ``adaptive_avg_pool2d`` record the Functions;
    a tensor with no gradient recorded never does."""
    monkeypatch.setattr(K, "kernel_backward",
                        lambda t: t.requires_grad and torch.is_grad_enabled())
    x = torch.randn(1, 2, 4, 6, dtype=torch.float64, requires_grad=True)
    y = R.resize_bilinear(x, (8, 12))
    z = R._interpolate(x, 2.0, 12)
    p = P.adaptive_avg_pool2d(x.to(torch.bfloat16), 3)
    assert type(y.grad_fn).__name__ == "BilinearResizeBackward"
    assert type(z.grad_fn).__name__ == "BilinearResizeBackward"
    assert torch.equal(y, z)
    assert type(p.grad_fn.next_functions[0][0]).__name__ \
        == "AdaptiveAvgPoolBackward"
    with torch.no_grad():
        assert R.resize_bilinear(x, (8, 12)).grad_fn is None
    gx = torch.autograd.grad((y * y).sum() + p.float().sum(), x)[0]
    monkeypatch.setattr(K, "kernel_backward", lambda t: False)
    x2 = x.detach().clone().requires_grad_()
    y2 = R.resize_bilinear(x2, (8, 12))
    p2 = P.adaptive_avg_pool2d(x2.to(torch.bfloat16), 3)
    want = torch.autograd.grad((y2 * y2).sum() + p2.float().sum(), x2)[0]
    _close(gx.numpy(), want.numpy())


@pytest.mark.parametrize("fn", ["resize_bilinear_bwd", "adaptive_pool_bwd"])
def test_wrappers_refuse_what_they_cannot_take(fn):
    wrapper = getattr(K, fn)
    g = torch.zeros(1, 2, 3, 4)
    with pytest.raises(ValueError, match="no kernel for device"):
        wrapper(g.to("meta"), (6, 8))
    with pytest.raises(ValueError):
        wrapper(g[0], (6, 8))


@pytest.mark.parametrize("n_out", [1, 7, 16, 23, 45, 90, 2048])
@pytest.mark.parametrize("n_in", [1, 3, 6, 22, 23, 45, 256])
def test_axis_taps_follow_torchs_forward(n_in, n_out):
    """F.interpolate of the identity (one-hot rows) in f32 reads back
    each output index's weights: they are ``axis_matrix``'s within one
    rounding of the source index (an ulp of n_in: the CPU's forward may
    round the product before it subtracts 0.5, where the card's
    multiply-add rounds once), and bit for bit at the power-of-two
    ratios, where the arithmetic is exact."""
    eye = torch.eye(n_in, dtype=torch.float32).reshape(n_in, 1, n_in, 1)
    fwd = F.interpolate(eye, size=(n_out, 1), mode="bilinear",
                        align_corners=False, antialias=False)
    got = fwd.reshape(n_in, n_out).t().numpy()
    want = KR.axis_matrix(n_in, n_out,
                          KR.axis_scale(n_in, n_out, None, torch.float32),
                          torch.float32)
    assert np.abs(got - want).max() <= 2.0 ** -22 * max(1, n_in)
    ratio = n_out / n_in
    if ratio in (1 / 8, 1 / 4, 1 / 2, 2, 4, 8):
        assert np.array_equal(got, want)


# -------------------------------------------------------- planted faults
def _plant_taps(monkeypatch, fault):
    real = KR.axis_taps

    def faulty(n_in, n_out, scale, dtype):
        i0, i1, l0, l1 = real(n_in, n_out, scale, dtype)
        if fault == "index":            # the second tap one further
            i1 = np.minimum(i1 + 1, n_in - 1)
        elif fault == "clamp":          # no clamp below 0
            src = scale * (np.arange(n_out) + 0.5) - 0.5
            i0 = np.floor(src).astype(np.int64).clip(0)
            l1 = (src - np.floor(src)).astype(l1.dtype)
            l0 = 1 - l1
        else:                           # the weight of another rounding
            l1 = l1 * (1 + 1e-9)
        return i0, i1, l0, l1
    monkeypatch.setattr(KR, "axis_taps", faulty)


@pytest.mark.parametrize("fault", ["index", "clamp", "weight"])
def test_planted_resize_faults_break_the_bound(fault, x64, monkeypatch):
    x, g = _resize_case("x4")
    want = _resize_vjp(x, g.shape[2:], g)
    _plant_taps(monkeypatch, fault)
    got = K.resize_bilinear_bwd_ref(torch.from_numpy(g), x.shape[2:])
    with pytest.raises(AssertionError):
        _close(got.numpy(), want, fault)


def test_planted_pool_fault_breaks_the_bound(x64, monkeypatch):
    (h, w), bins = POOLS["pool3_23x30"]
    x, g = _rand(5, (N, C, h, w)), _rand(6, (N, C, bins, bins))
    want = _pool_vjp(x, bins, g, monkeypatch)
    real = KP.pool_bins
    monkeypatch.setattr(KP, "pool_bins",
                        lambda n_in, n: (real(n_in, n)[0],
                                         real(n_in, n)[1] + 1))
    got = K.adaptive_pool_bwd_ref(torch.from_numpy(g), (h, w))
    with pytest.raises(AssertionError):
        _close(got.numpy(), want, "pool")


# --------------------------------------------------------- uneven shards
WORLDS = ((2, 13), (3, 13), (4, 13))
SHARDED = ("resize_x2", "resize_x4", "resize_x8", "resize_half",
           "resize_quarter")
LIMIT = 150.0


def _sharded_calls(h, w=8):
    calls, want = [], []
    x = _rand(0, (N, C, h, w))
    for i, name in enumerate(SHARDED):
        y = TS.OPS[name][0](torch.from_numpy(x), {})
        cot = _rand(100 + i, tuple(y.shape))
        calls.append(("op_case", (name, x, cot, {})))
    pools = [n for n in TS.REDUCTIONS if n != "global_avg_pool"]
    for i, name in enumerate(pools):
        y = TS.REDUCTIONS[name](torch.from_numpy(x))
        cot = _rand(200 + i, tuple(y.shape))
        calls.append(("reduction_case", (name, x, cot)))
    for i, (name, (bh, bw)) in enumerate(TS.UPSAMPLES.items()):
        calls.append(("upsample_case", (name, _rand(300 + i, (N, C, bh, bw)),
                                        _rand(400 + i, (N, C, h, w)))))
    for case, args in calls:
        want.append(getattr(TS, case)(*args, 1))
    return calls, want


@pytest.fixture(scope="module")
def sharded_runs():
    torch.set_num_threads(1)
    out = {}
    for s, h in WORLDS:
        calls, want = _sharded_calls(h)
        ranks = launch.run_ranks(
            TR.routed_case, s, [(c, a + (s,)) for c, a in calls],
            timeout=LIMIT)
        out[s, h] = (calls, want, ranks)
    return out


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"S{w[0]}_T{w[1]}")
def test_sharded_backward_on_the_kernel_route_matches_the_whole_tensor(
        sharded_runs, world):
    """Each rank's rows of y and dx on the K5/K6 route against torch's
    backward on the whole tensor, f64 within TOL; every rank ran K6's
    plain version for PPM's four pools and K5's for the three replicated
    resizes, and the ranks together for each sharded resize (a rank whose
    rows no output row reads runs no resize in its backward)."""
    calls, want, ranks = sharded_runs[world]
    for k, ((case, args), one) in enumerate(zip(calls, want)):
        outs = [r[k] for r in ranks]
        name = args[0]
        if case == "op_case":
            for key in ("y", "dx"):
                _close(np.concatenate([o[key] for o in outs], axis=2),
                       one[key], f"{name} {key}")
        elif case == "reduction_case":
            for o in outs:
                _close(o["y"], one["y"], name)
            _close(np.concatenate([o["dx"] for o in outs], axis=2),
                   one["dx"], name)
        else:
            _close(np.concatenate([o["y"] for o in outs], axis=2),
                   one["y"], name)
            for o in outs:
                _close(o["dx"], one["dx"], name)
    counts = [r[-1] for r in ranks]
    assert all(c["adaptive_pool_bwd"] == 4 for c in counts), counts
    assert all(c["resize_bilinear_bwd"] >= 3 for c in counts), counts
    assert sum(c["resize_bilinear_bwd"] - 3 for c in counts) >= len(SHARDED)
