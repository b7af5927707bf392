"""The port's ``fused_cgblock_pre`` module against the JAX reference, on the
CPU.

A CPU tensor takes the plain ``cgblock_pre_ref``; these tests hold it
against the reference's plain XLA version and against its Pallas kernel in
interpret mode (as ``tests/test_pallas_cgblock.py`` runs it), with inputs
from a numpy seed. The CUDA kernel is compared with the same plain version
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esn_tpu.ops.pallas import cgblock as JC

from esn_tpu_torch.ops import kernels as K


def _args(rng, n, h, w, c):
    half = c // 2
    return (rng.randn(n, h, w, c).astype(np.float32),
            (rng.randn(c, half) * 0.3).astype(np.float32),
            (rng.randn(half) * 0.1 + 1.0).astype(np.float32),
            (rng.randn(half) * 0.1).astype(np.float32),
            rng.uniform(0.1, 0.4, half).astype(np.float32),
            (rng.randn(3, 3, half) * 0.3).astype(np.float32),
            (rng.randn(3, 3, half) * 0.3).astype(np.float32),
            (rng.randn(c) * 0.1 + 1.0).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            rng.uniform(0.1, 0.4, c).astype(np.float32))


def _port(args, dtype):
    x, *params = [torch.from_numpy(a) for a in args]
    return (x.to(dtype), *params)


def _jax(args, dtype):
    x, *params = [jnp.asarray(a) for a in args]
    return (x.astype(dtype), *params)


# j: f32: the reduce and both depthwise sums run in f32 in other orders on
# the two sides: atol = rtol = 2e-5. bf16: y and j round to bf16 and the
# plain versions round loc/sur too, the Pallas kernel does not: one bf16
# rounding (2^-8 relative) of a value as large as the largest |j|, so
# atol = 2^-7 max|j|, rtol = 2^-7.
# sums: |d sum| <= SUM_TOL * sum |j| per (n, c): f32 association; in bf16
# the kernel sums the f32 j, the plain versions the rounded j.
SUM_TOL = {"float32": 1e-5, "bfloat16": 4e-3}


def _check(got_j, got_s, want_j, want_s, name):
    if name == "float32":
        atol = rtol = 2e-5
    else:
        atol, rtol = 2.0 ** -7 * np.abs(want_j).max(), 2.0 ** -7
    np.testing.assert_allclose(got_j, want_j, atol=atol, rtol=rtol)
    scale = np.abs(want_j).sum((1, 2))
    assert np.all(np.abs(got_s - want_s) <= SUM_TOL[name] * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c, d, h, w, interpret", [
    (64, 2, 32, 48, True), (128, 4, 40, 64, True),
    (64, 2, 34, 48, True),      # no tile divides H = 34
    (24, 4, 9, 7, False),       # d >= H/2, odd half (12)
])
def test_cgblock_pre_ref_matches_reference(c, d, h, w, interpret, dtype):
    """Port plain version == JAX plain version == JAX Pallas kernel
    (interpret), per dtype tolerance. At (9, 7) d=4 the Pallas kernel
    itself is off (its one-row tile leaves a clamp shift outside {-d, 0,
    d}), so that case holds the port to the JAX plain version only."""
    args = _args(np.random.RandomState(0), 2, h, w, c)
    tdt = getattr(torch, dtype)
    j, s = K.cgblock_pre_ref(*_port(args, tdt), d=d)
    assert j.dtype == tdt and j.shape == (2, h, w, c)
    assert s.dtype == torch.float32 and s.shape == (2, c)
    got_j, got_s = j.float().numpy(), s.numpy()
    jargs = _jax(args, getattr(jnp, dtype))
    ref = JC.cgblock_pre_ref(*jargs, d=d)
    _check(got_j, got_s, np.asarray(ref, np.float32),
           np.asarray(jnp.sum(ref.astype(jnp.float32), axis=(1, 2))), dtype)
    if interpret:
        pj, ps = JC.fused_cgblock_pre(*jargs, d=d, impl="interpret")
        _check(got_j, got_s, np.asarray(pj, np.float32), np.asarray(ps),
               dtype)


def _grid(args):
    """x, w1, a1, b1 on a dyadic grid: the reduce and its affine are exact in
    f32 in any order, so y is the same on both sides of a comparison."""
    args = list(args)
    for i, k in ((0, 8), (1, 32), (2, 16), (3, 256)):
        args[i] = (np.round(args[i] * k) / k).astype(np.float32)
    return args



@pytest.mark.parametrize("c, d, h, w", [(64, 2, 32, 48), (128, 4, 40, 64),
                                        (64, 2, 34, 48)])
def test_cgblock_pre_kernel_rounding_matches_pallas(c, d, h, w):
    """The emulation of the kernel's rounding == the Pallas kernel
    (interpret) in bf16 on grid inputs: j differs only where the two f32
    orders of the tap sums cross a bf16 rounding (<= 1e-3 of the elements,
    one bf16 step each), sums within 1e-5 of sum|j|. The plain version,
    which rounds loc and sur too, differs at ~46% of the elements. In f32
    the emulation is the plain version."""
    args = _grid(_args(np.random.RandomState(4), 2, h, w, c))
    j, s = K.cgblock_pre_kernel_rounding(*_port(args, torch.bfloat16), d=d)
    assert j.dtype == torch.bfloat16 and s.dtype == torch.float32
    pj, ps = JC.fused_cgblock_pre(*_jax(args, jnp.bfloat16), d=d,
                                  impl="interpret")
    pallas = (torch.tensor(np.asarray(pj, np.float32)),
              torch.tensor(np.asarray(ps)))
    differ, far, sum_rel = K.bf16_rounding_gap(j, s, *pallas)
    assert differ <= 1e-3 * j.numel() and far == 0, (differ, far)
    assert sum_rel <= 1e-5
    plain_j, plain_s = K.cgblock_pre_ref(*_port(args, torch.bfloat16), d=d)
    assert K.bf16_rounding_gap(plain_j, plain_s, *pallas)[0] > 0.2 * j.numel()
    f32 = _port(args, torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(
        K.cgblock_pre_kernel_rounding(*f32, d=d), K.cgblock_pre_ref(*f32, d=d)))


def test_cgblock_pre_zero_pads_y_not_x():
    """At the image's edge the taps read y = 0, not PReLU(b1): with every
    x = 0 and b1 > 0, y is a constant inside the image, so loc at a
    corner sums 4 of the 9 taps and at the centre all 9."""
    c, d = 8, 2
    args = list(_args(np.random.RandomState(1), 1, 7, 9, c))
    args[0][:] = 0.0
    args[3][:] = 0.5                              # b1 > 0: y = 0.5 inside
    args[5][:] = 1.0                              # loc taps all 1
    args[7][:], args[8][:], args[9][:] = 1.0, 0.0, 1.0   # j = loc, sur
    j, _ = K.cgblock_pre_ref(*_port(args, torch.float32), d=d)
    loc = j[0, :, :, :c // 2]
    assert torch.allclose(loc[0, 0], torch.full((c // 2,), 4 * 0.5))
    assert torch.allclose(loc[3, 4], torch.full((c // 2,), 9 * 0.5))
    jargs = _jax(args, jnp.float32)
    want = np.asarray(JC.cgblock_pre_ref(*jargs, d=d))
    np.testing.assert_allclose(j.numpy(), want, atol=1e-6)


def test_fused_cgblock_pre_takes_plain_version_on_cpu():
    args = _port(_args(np.random.RandomState(2), 1, 6, 10, 16),
                 torch.float32)
    before = dict(K.LAUNCHES)
    j, s = K.fused_cgblock_pre(*args, d=2)
    j0, s0 = K.cgblock_pre_ref(*args, d=2)
    assert torch.equal(j, j0) and torch.equal(s, s0)
    assert K.LAUNCHES == before          # no kernel launched on the CPU


def test_fused_cgblock_pre_rejects_what_it_cannot_run():
    args = _port(_args(np.random.RandomState(3), 1, 6, 6, 8), torch.float32)
    with pytest.raises(ValueError, match="dilation"):
        K.fused_cgblock_pre(*args, d=0)
    with pytest.raises(ValueError, match="w1 has shape"):
        K.fused_cgblock_pre(args[0], args[1][:, :3], *args[2:], d=1)
    with pytest.raises(ValueError, match="even C"):
        K.fused_cgblock_pre(args[0][..., :7], *args[1:], d=1)
    with pytest.raises(ValueError, match="p2 on"):
        K.fused_cgblock_pre(*args[:9], args[9].to("meta"), d=1)
    # a device with no kernel raises; it never falls back to the CPU
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel for device"):
        K.fused_cgblock_pre(*meta, d=1)
