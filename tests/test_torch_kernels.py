"""The port's kernel modules against the JAX reference, on the CPU.

On a CPU tensor each wrapper of ``esn_tpu_torch.ops.kernels`` runs its
plain PyTorch version; these tests hold that plain version against the
reference's Pallas kernel, run in interpret mode as the reference's own
tests run it, and against the reference's plain XLA version. Inputs come
from numpy with a fixed seed. The CUDA kernels themselves are compared
with the same plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esn_tpu import nn as jnn
from esn_tpu.ops.pallas import dsconv as JD
from esn_tpu.ops.pallas import resize_argmax as JR

from esn_tpu_torch.nn import BatchNorm
from esn_tpu_torch.ops import classify
from esn_tpu_torch.ops import kernels as K

ATOL = RTOL = 1e-5      # f32, both sides sum in f32 in other orders


def _dsconv_args(rng, n, h, w, ci, co):
    return (rng.randn(n, h, w, ci).astype(np.float32),
            (rng.randn(3, 3, ci) * 0.3).astype(np.float32),
            (rng.rand(ci) + 0.5).astype(np.float32),
            (rng.randn(ci) * 0.1).astype(np.float32),
            (rng.randn(ci, co) * 0.2).astype(np.float32),
            (rng.rand(co) + 0.5).astype(np.float32),
            (rng.randn(co) * 0.1).astype(np.float32))


@pytest.mark.parametrize("acts", [("relu", "relu"), ("relu6", "none"),
                                  ("none", "relu6")])
@pytest.mark.parametrize("hw", [(16, 16), (9, 15)])
@pytest.mark.parametrize("stride", [1, 2])
def test_dsconv_ref_matches_reference(stride, hw, acts):
    """Port plain version == JAX Pallas kernel (interpret) == JAX plain
    version, f32, odd H/W included."""
    args = _dsconv_args(np.random.RandomState(0), 2, *hw, 8, 12)
    kw = dict(stride=stride, act1=acts[0], act2=acts[1])
    got = K.dsconv_ref(*map(torch.from_numpy, args), **kw).numpy()
    jargs = [jnp.asarray(a) for a in args]
    pallas = np.asarray(JD.fused_dsconv(*jargs, impl="interpret", **kw))
    plain = np.asarray(JD.dsconv_ref(*jargs, **kw))
    assert got.shape == pallas.shape == plain.shape
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, plain, atol=ATOL, rtol=RTOL)


def _dyadic_dsconv_args(rng, n, h, w, ci, co):
    """Seeded K2 inputs with x, dw, a1 and b1 on a dyadic grid: the
    depthwise sums and their affine are exact in f32 in any order (but
    not in bf16), so every side rounds the same mid."""
    q = lambda a, k: (np.round(a * k) / k).astype(np.float32)  # noqa: E731
    x, dw, a1, b1, pw, a2, b2 = _dsconv_args(rng, n, h, w, ci, co)
    return q(x * 2, 8), q(dw, 32), q(a1, 16), q(b1, 256), pw, a2, b2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw, stride", [((16, 16), 1), ((16, 16), 2),
                                        ((9, 15), 1), ((9, 15), 2)])
def test_dsconv_kernel_rounding_matches_pallas(hw, stride, dtype):
    """The emulation of the CUDA kernel's rounding points == the JAX
    Pallas kernel (interpret), which rounds at the same points (mid to
    x's dtype before the product, pw to x's dtype, the output once): f32
    within 1e-5; bf16 on dyadic inputs, where mid is the same on both
    sides and only the f32 order of the product's sum differs: at most
    2 + 1e-3 of the elements differ, none by more than one bf16 step. And
    against the JAX plain version, which rounds the depthwise result and
    not mid: f32 within 1e-5, bf16 within chip_smoke's DSCONV_TOL (5e-2,
    2e-2)."""
    args = _dyadic_dsconv_args(np.random.RandomState(8), 2, *hw, 24, 16)
    kw = dict(stride=stride, act1="relu6", act2="relu")
    tdt = getattr(torch, dtype)
    targs = [torch.from_numpy(a) for a in args]
    targs[0] = targs[0].to(tdt)
    got = K.dsconv_kernel_rounding(*targs, **kw)
    assert got.dtype == tdt
    jargs = [jnp.asarray(a) for a in args]
    jargs[0] = jargs[0].astype(dtype)
    pallas = torch.from_numpy(np.array(
        JD.fused_dsconv(*jargs, impl="interpret", **kw).astype(jnp.float32)))
    plain = torch.from_numpy(np.array(
        JD.dsconv_ref(*jargs, **kw).astype(jnp.float32)))
    assert got.shape == pallas.shape == plain.shape
    if dtype == "float32":
        for want in (pallas, plain):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                       rtol=RTOL)
        return
    differ, far = K.bf16_step_gap(got, pallas)
    assert differ <= 2 + 1e-3 * got.numel() and far == 0, (differ, far)
    torch.testing.assert_close(got.float(), plain, atol=5e-2, rtol=2e-2)


def test_fused_dsconv_takes_plain_version_on_cpu():
    args = [torch.from_numpy(a) for a in
            _dsconv_args(np.random.RandomState(1), 1, 7, 10, 4, 8)]
    before = dict(K.LAUNCHES)
    got = K.fused_dsconv(*args, stride=2)
    assert torch.equal(got, K.dsconv_ref(*args, stride=2))
    assert K.LAUNCHES == before          # no kernel launched on the CPU


def test_fused_dsconv_rejects_what_it_cannot_run():
    args = [torch.from_numpy(a) for a in
            _dsconv_args(np.random.RandomState(2), 1, 6, 6, 4, 8)]
    with pytest.raises(ValueError, match="stride"):
        K.fused_dsconv(*args, stride=3)
    with pytest.raises(ValueError, match="pw has shape"):
        K.fused_dsconv(*args[:4], args[4][:3], *args[5:])
    with pytest.raises(ValueError, match="acts"):
        K.fused_dsconv(*args, act1="gelu")
    # a device with no kernel raises; it never falls back to the CPU
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel for device"):
        K.fused_dsconv(*meta)


def test_fold_bn_matches_batchnorm_eval():
    rng = np.random.RandomState(3)
    c = 8
    mean, beta = rng.randn(c), rng.randn(c)
    var, gamma = rng.rand(c) + 0.1, rng.rand(c) + 0.5
    x = rng.randn(2, c, 4, 5).astype(np.float32)
    bn = BatchNorm(c).eval()
    with torch.no_grad():
        for t, v in ((bn.running_mean, mean), (bn.running_var, var),
                     (bn.weight, gamma), (bn.bias, beta)):
            t.copy_(torch.from_numpy(v))
        want = bn(torch.from_numpy(x)).numpy()
    f32 = lambda v: torch.from_numpy(v.astype(np.float32))
    a, b = K.fold_bn(f32(mean), f32(var), f32(gamma), f32(beta), eps=bn.eps)
    got = (torch.from_numpy(x) * a[:, None, None] + b[:, None, None]).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    ja, jb = JD.fold_bn(*(jnp.asarray(v, jnp.float32)
                          for v in (mean, var, gamma, beta)), eps=bn.eps)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=0, rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=1e-6,
                               rtol=1e-6)
    # and the reference's own eval BN on the same numbers
    jbn = jnn.BatchNorm(c)
    jwant = jnn.apply(jbn, {"params": {"scale": gamma.astype(np.float32),
                                       "bias": beta.astype(np.float32)},
                            "stats": {"mean": mean.astype(np.float32),
                                      "var": var.astype(np.float32)}},
                      jnp.asarray(x.transpose(0, 2, 3, 1)), train=False)
    np.testing.assert_allclose(got, np.asarray(jwant).transpose(0, 3, 1, 2),
                               atol=ATOL, rtol=RTOL)


def _top2_gap(y, r):
    """Gap between the two largest classes of the f32 upsample of y."""
    n, h, w, c = y.shape
    up = torch.nn.functional.interpolate(
        torch.from_numpy(y).permute(0, 3, 1, 2), size=(h * r, w * r),
        mode="bilinear", align_corners=False)
    top = torch.topk(up, 2, dim=1).values
    return (top[:, 0] - top[:, 1]).numpy()


# (r, hw, C): the first six keep their ids; then the factors 5 and 8 and
# C = 2 and 64, as the card holds K1 to this oracle (a few cases, not the
# cross product: the Pallas kernel in interpret mode costs ~r*r*C)
@pytest.mark.parametrize("r, hw, c", [
    pytest.param(2, (6, 10), 19, id="2-hw0"),
    pytest.param(2, (5, 7), 19, id="2-hw1"),
    pytest.param(3, (6, 10), 19, id="3-hw0"),
    pytest.param(3, (5, 7), 19, id="3-hw1"),
    pytest.param(4, (6, 10), 19, id="4-hw0"),
    pytest.param(4, (5, 7), 19, id="4-hw1"),
    pytest.param(5, (5, 7), 19, id="5-hw1-c19"),
    pytest.param(8, (5, 7), 2, id="8-hw1-c2"),
    pytest.param(2, (5, 7), 64, id="2-hw1-c64"),
    pytest.param(3, (5, 7), 64, id="3-hw1-c64"),
])
def test_resize_argmax_ref_matches_reference(r, hw, c):
    """Port plain version == JAX Pallas kernel (interpret) exactly, except
    at near-ties (top-2 f32 gap < 1e-5), where both answers are right."""
    y = np.random.RandomState(4).randn(2, *hw, c).astype(np.float32)
    got = K.resize_argmax_ref(torch.from_numpy(y), r).numpy()
    want = np.asarray(JR.resize_argmax(jnp.asarray(y), r, interpret=True))
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape == (2, hw[0] * r, hw[1] * r)
    tie = _top2_gap(y, r) < 1e-5
    np.testing.assert_array_equal(got[~tie], want[~tie])
    # and the reference's plain XLA tail
    plain = np.asarray(JR.resize_argmax_ref(jnp.asarray(y), r))
    np.testing.assert_array_equal(got[~tie], plain[~tie])


def test_resize_argmax_first_max_and_edges():
    """Exact ties go to the first class; a constant field keeps its argmax
    up to the clamped edges."""
    zeros = torch.zeros((1, 4, 8, 6))
    assert torch.all(K.resize_argmax(zeros, 2) == 0)
    vals = np.random.RandomState(5).randn(5).astype(np.float32)
    y = torch.from_numpy(np.tile(vals, (1, 4, 6, 1)))
    assert torch.all(K.resize_argmax(y, 4) == int(np.argmax(vals)))


def test_resize_argmax_wrapper():
    y = torch.from_numpy(np.random.RandomState(6).randn(1, 3, 5, 7)
                         .astype(np.float32))
    before = dict(K.LAUNCHES)
    assert torch.equal(K.resize_argmax(y, 3), K.resize_argmax_ref(y, 3))
    assert K.LAUNCHES == before
    with pytest.raises(ValueError):
        K.resize_argmax(y, 9)
    with pytest.raises(ValueError, match="no kernel for device"):
        K.resize_argmax(y.to("meta"), 2)


@pytest.mark.parametrize("shape, out_hw, eligible", [
    ((1, 4, 6, 19), (32, 48), True),      # r = 8
    ((1, 4, 6, 19), (8, 12), True),       # r = 2
    ((1, 4, 6, 19), (4, 6), False),       # r = 1
    ((1, 4, 6, 19), (36, 54), False),     # r = 9
    ((1, 4, 6, 19), (8, 18), False),      # non-uniform
    ((1, 4, 6, 19), (10, 15), False),     # non-integer
    ((1, 4, 6, 1), (8, 12), False),       # one class
    ((1, 4, 6, 65), (8, 12), False),      # too many classes
])
def test_fused_resize_argmax_eligibility(shape, out_hw, eligible):
    """The reference's rule (ops/classify.py): integer uniform scale
    2 <= r <= 8, 2 <= C <= 64; otherwise the unfused tail."""
    y = torch.from_numpy(np.random.RandomState(7).randn(*shape)
                         .astype(np.float32))
    out = classify.fused_resize_argmax(y, out_hw)
    assert (out is not None) == eligible
    tail = classify.resize_tail_argmax(y, out_hw)
    assert tail.shape == (1, *out_hw) and tail.dtype == torch.int32
    if eligible:
        assert torch.equal(out, tail)


def test_ctypes_signatures_match_the_c_sources():
    """Every ``extern "C"`` entry point of ``csrc/*.cu`` has the argtypes
    that ``_build`` gives ctypes, parameter by parameter (ctypes does not
    check a call's arity against the C function)."""
    import ctypes
    import re
    from esn_tpu_torch.ops.kernels import _build
    c_types = {"int": ctypes.c_int, "float": ctypes.c_float,
               "int64_t": ctypes.c_int64, "double": ctypes.c_double}
    found = {}
    for src in _build.SRC_DIR.glob("*.cu"):
        text = src.read_text()
        for m in re.finditer(r'extern "C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)',
                             text):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            found[m.group(1)] = [
                ctypes.c_void_p if "*" in p else c_types[p.split()[0]]
                for p in params]
    assert set(found) == set(_build.SIGNATURES)
    for name, (argtypes, _) in _build.SIGNATURES.items():
        assert found[name] == argtypes, name
