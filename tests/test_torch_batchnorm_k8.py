"""K8's autograd Function (``ops.kernels.batchnorm``) driven through the
kernels' plain versions on the CPU, against the composite
``BatchNorm._normalise`` that a CPU tensor takes: the f64 gradients, the
f32 forward, affine gradients and running statistics, a recompute's
replay, ``affine=False``, eval, and the data-parallel world sums under
gloo; the kernels' plan from the shapes alone. The kernels themselves are
held on the card (``tests/test_torch_cuda.py``)."""
import math

import numpy as np
import pytest
import torch

import _torch_parallel as TP
from esn_tpu_torch.nn import BatchNorm, Recompute
from esn_tpu_torch.ops import kernels as K
from esn_tpu_torch.ops.kernels import batchnorm as KB
from esn_tpu_torch.parallel import launch

SHAPES = [(4, 35, 6, 7), (6, 8, 1, 1), (3, 16, 5, 9)]


def _module(c, dtype, affine=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c, affine=affine).to(dtype)
    with torch.no_grad():
        if affine:
            bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
            bn.bias.copy_(torch.randn(c, generator=g) * 0.1)
        bn.running_mean.copy_(torch.randn(c, generator=g) * 0.5)
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return bn


def _x(shape, dtype, channels_last, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g, dtype=torch.float64) * 2 + 1)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    return x.to(dtype).contiguous(memory_format=fmt)


def _pair(bn):
    """Two copies of ``bn``: one for the composite, one for K8's route."""
    other = BatchNorm(bn.num_features, affine=bn.affine).to(
        bn.running_mean.dtype)
    other.load_state_dict(bn.state_dict())
    return bn, other


def _run(bn, x, route, cot):
    """y, dx, dweight, dbias and the running statistics after one forward
    and the backward of ``(y * cot).sum()``."""
    t = x.detach().clone().requires_grad_()
    y = bn._kernels(t) if route == "kernels" else bn(t)
    (y * cot).sum().backward()
    out = [y.detach(), t.grad]
    if bn.affine:
        out += [bn.weight.grad, bn.bias.grad]
    return out + [bn.running_mean.clone(), bn.running_var.clone()]


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("training", [True, False])
def test_k8_function_gradcheck_f64(training, affine, channels_last):
    """The Function's backward (the plain versions of K8's backward sums
    and dx) against finite differences of its forward, in f64, training
    (batch statistics, their gradient terms) and eval (the running
    statistics, constants)."""
    bn = _module(5, torch.float64, affine)
    x = _x((3, 5, 4, 6), torch.float64, channels_last).requires_grad_()
    n = 3 * 4 * 6
    centre = bn.running_mean.clone() if training else None

    def f(x, w, b):
        return K.BatchNormFn.apply(
            x, w, b, bn.running_mean, bn.running_var, centre, bn.eps,
            bn.momentum, (n, n / (n - 1)), False, None)

    params = ((bn.weight, bn.bias) if affine else (None, None))
    assert torch.autograd.gradcheck(f, (x, *params))


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_k8_route_matches_the_composite_f32(shape, channels_last, affine):
    """Training in f32: K8's route (plain versions) and the composite give
    the same y, dx, dweight, dbias and running statistics within f32
    rounding; no kernel counts a launch on the CPU."""
    bn, other = _pair(_module(shape[1], torch.float32, affine))
    x = _x(shape, torch.float32, channels_last)
    cot = _x(shape, torch.float32, channels_last, seed=2)
    before = dict(K.LAUNCHES)
    want = _run(bn, x, "composite", cot)
    got = _run(other, x, "kernels", cot)
    assert K.LAUNCHES == before
    assert got[0].stride() == x.stride()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12),
                                        (torch.float32, 2e-5)])
@pytest.mark.parametrize("shape", SHAPES)
def test_k8_route_matches_the_composite_in_eval(shape, dtype, tol):
    """Eval: the apply of the running statistics and, under a gradient,
    its backward (``scale * dy`` and the affine sums) equal the
    composite's within rounding; the running statistics stay. In bf16
    the composite rounds the scale, the product and the sum to bf16, the
    apply once: within two bf16 steps of the largest |y|."""
    bn, other = _pair(_module(shape[1], dtype))
    bn.eval()
    other.eval()
    x = _x(shape, dtype, True)
    cot = _x(shape, dtype, True, seed=2)
    want = _run(bn, x, "composite", cot)
    got = _run(other, x, "kernels", cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol * float(
            w.abs().max()))
    with torch.no_grad():
        assert torch.equal(other._kernels(x), got[0])
        xb = x.to(torch.bfloat16)
        yb, wb = other._kernels(xb).float(), bn(xb).float()
        assert float((yb - wb).abs().max()) <= 2 ** -7 * float(
            wb.abs().max())


def test_k8_recompute_replays_on_the_kept_mean():
    """Under ``Recompute``: the first run centres on the running mean and
    moves the statistics once; the replay centres on the kept mean,
    gives the first run's y bit for bit and moves nothing, as the
    composite does."""
    for route in ("composite", "kernels"):
        bn = _module(6, torch.float32)
        x = _x((2, 6, 5, 4), torch.float32, True)
        first, again = Recompute(bn).contexts()
        mean0 = bn.running_mean.clone()
        with first:
            y1 = bn._kernels(x) if route == "kernels" else bn(x)
        moved = (bn.running_mean.clone(), bn.running_var.clone())
        assert not torch.equal(moved[0], mean0)
        with again:
            y2 = bn._kernels(x) if route == "kernels" else bn(x)
        assert torch.equal(y1, y2)
        assert torch.equal(bn.running_mean, moved[0])
        assert torch.equal(bn.running_var, moved[1])
        if route == "composite":
            want = (y1, moved)
    torch.testing.assert_close(y1, want[0], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(moved, want[1], rtol=2e-5, atol=2e-5)


def test_k8_cpu_tensor_never_reaches_the_function(monkeypatch):
    """A CPU tensor takes the composite in training and in eval."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached K8")

    monkeypatch.setattr(K.BatchNormFn, "apply", refuse)
    monkeypatch.setattr(K, "bn_apply", refuse)
    bn = _module(4, torch.float32)
    x = _x((2, 4, 3, 3), torch.float32, False).requires_grad_()
    bn(x).sum().backward()
    bn.eval()
    bn(x)


@pytest.mark.parametrize("route", ["composite", "kernels"])
def test_k8_world_sums_under_gloo_match_one_process(route):
    """Two ranks under gloo on the CPU, f64, each with half the batch:
    K8's route (its world sums of the moments and of the backward's sums)
    and the composite give one process's y and dx rows, its all-reduced
    affine gradients and running statistics, equal on both ranks."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 3, 5, 6) * 2 + 1
    cot = rng.randn(4, 3, 5, 6)
    params = {"weight": rng.uniform(0.5, 1.5, 3), "bias": rng.randn(3) * 0.1,
              "running_mean": rng.randn(3) * 0.5,
              "running_var": rng.uniform(0.5, 1.5, 3)}
    one = TP.bn_case(x, cot, params)
    out = launch.run_ranks(TP.bn_case, 2, x, cot, params, "float64", route,
                           timeout=120.0)
    for r, o in enumerate(out):
        for k in ("y", "dx"):
            np.testing.assert_allclose(o[k], one[k][2 * r:2 * r + 2],
                                       rtol=0, atol=1e-12)
        for k in ("dweight", "dbias", "running_mean", "running_var"):
            np.testing.assert_allclose(o[k], one[k], rtol=0, atol=1e-12)
    launch.assert_ranks_equal([{k: o[k] for k in (
        "dweight", "dbias", "running_mean", "running_var")} for o in out])


# (a, c, b, itemsize): channels_last rows of the zoo's widths and of odd
# ones, NCHW planes whole in 16-byte vectors or not, empty and tiny ones
PLANS = [(16 * 512 * 1024, 32, 1, 2), (8 * 512 * 1024, 35, 1, 2),
         (8 * 256 * 512, 131, 1, 2), (16 * 128 * 256, 384, 1, 2),
         (32 * 64 * 128, 576, 1, 4), (8 * 16 * 16, 1024, 1, 8),
         (3 * 7 * 5, 19, 1, 2), (1, 3, 1, 4), (0, 16, 1, 2),
         (16, 32, 512 * 1024, 2), (8, 35, 45 * 60, 2), (2, 131, 7 * 5, 8),
         (5, 8, 1, 2), (2, 16, 0, 4)]


@pytest.mark.parametrize("a, c, b, itemsize", PLANS)
def test_k8_plan_covers_the_tensor(a, c, b, itemsize):
    """The plan the kernels check (csrc/batchnorm.cu, ``valid``): rows
    tiles a whole number of rows in 16-byte vectors, blocks within 512
    threads and 48 KB of partial sums, a thread per (tile, slot) and the
    ragged tile walked by one; planes 16-byte loads only where a plane is
    whole vectors; the grids within their limits and at least one block."""
    p = KB.bn_plan(a, c, b, itemsize)
    vec = 16 // itemsize
    assert p.reduce_grid >= 1 and p.apply_grid >= 1
    if b == 1:
        lanes = p.slots * p.vec
        assert p.vec == vec and lanes % c == 0 and lanes == math.lcm(c, vec)
        assert p.slots * p.tiles <= KB.MAX_THREADS
        acc = 8 if itemsize == 8 else 4
        assert p.slots * p.tiles * p.vec * acc <= 48 * 1024
        full, step = a * c // lanes, p.reduce_grid * p.tiles
        # the thread whose walk ends on the ragged tile, and only it
        ends = [t0 + -(-(full - t0) // step) * step if t0 < full else t0
                for t0 in range(step)]
        assert sorted(ends).count(full) == 1
        assert p.parts(a) == p.reduce_grid
    else:
        assert p.slots == p.tiles == 0
        assert p.vec == (vec if b % vec == 0 else 1)
        assert p.reduce_grid <= 65535 and p.apply_grid <= 65535
        assert p.parts(a) == a * p.reduce_grid
