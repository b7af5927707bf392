"""BatchNorm on the card (K8, ``csrc/batchnorm.cu``).

``nn.BatchNorm`` sends every CUDA tensor here; a CPU tensor keeps the
plain composite ``BatchNorm._normalise``, the oracle of the tests against
the reference. Three wrappers, each a kernel on a CUDA tensor and its
plain version on the CPU:

- :func:`bn_moments`: the training statistics. The per-channel sums of
  ``u = x - centre`` and ``u^2`` (the running mean the module centres on),
  two-stage in a fixed order, then ``mean = centre + sum(u)/n`` and the
  biased variance clamped at 0, the running statistics moved as the
  reference moves them (momentum, the unbiased factor). Under a group the
  sums are world-summed first (``reduce``). The sums are f64, of terms
  exact in f64, so they hardly depend on their order: the statistics are
  the same whatever the tiling or the ranks' split of the batch.
- :func:`bn_apply`: ``y = x * scale + offset`` with ``scale = rsqrt(var +
  eps) * weight`` and ``offset = bias - mean * scale``, in f32 (f64 for
  f64) as the composite rounds it, rounded once to x's dtype (in eval an
  f32 y is the composite's to the bit); the batch's statistics in
  training, the running ones in eval.
- :func:`bn_backward`: ``sum(dy)`` and ``sum(dy * xh)``, ``xh = (x - mean)
  * rstd`` recomputed from x, then ``dx = scale * (dy - sum(dy)/n - xh *
  sum(dy xh)/n)`` (``scale * dy`` in eval); ``dweight = sum(dy xh)``,
  ``dbias = sum(dy)`` of this rank's batch.

:class:`BatchNormFn` ties them into one autograd Function, which saves x
in its own dtype and the C-sized statistics only. The kernels take x in
channels_last or contiguous NCHW memory (another layout is copied into the
nearer one) and follow a plan made here from the shapes alone
(:func:`bn_plan`), so the plan moves no bit.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from . import LAUNCHES, _build
from .resize_bilinear_bwd import _DTYPE_CODES, _acc

Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]

# the H100's SMs: the plans aim at a few blocks on each (a constant, so
# that the plan, and with it every sum's order, is the same on any card)
SMS = 132
MAX_THREADS = 512          # a rows block's threads, at most
PLANE_THREADS = 256
PLANE_VECTORS = 4          # 16-byte vectors a plane thread, about
# the finishing launch's modes (csrc/batchnorm.cu, Finish)
_SUMS, _STATS, _GRAD = 0, 1, 2


class BnPlan(NamedTuple):
    """What :func:`bn_plan` hands the kernels, in this order: ``vec``
    elements a load (16 bytes, or 1 for planes that are not whole
    vectors); rows: a block is ``slots`` x ``tiles`` threads, ``slots``
    16-byte vectors a tile of ``lcm(c, vec)`` elements; planes: both 0;
    ``reduce_grid`` and ``apply_grid``: rows, the blocks of the reductions
    and of the elementwise passes; planes, chunks a plane."""
    vec: int
    slots: int
    tiles: int
    reduce_grid: int
    apply_grid: int

    def parts(self, a: int) -> int:
        """Rows of partial sums the reduction writes."""
        return self.reduce_grid if self.slots else a * self.reduce_grid


def bn_plan(a: int, c: int, b: int, itemsize: int) -> BnPlan:
    """The kernels' tiling of x seen as (a, c, b): rows (``b == 1``,
    channels_last) or planes (NCHW), from the shapes alone."""
    vec = 16 // itemsize
    if b == 1:
        slots = c // math.gcd(c, vec)
        if slots > MAX_THREADS:
            raise ValueError(f"batchnorm: {c} channels make a tile of {slots} "
                             f"16-byte vectors, over {MAX_THREADS} threads")
        tiles = max(1, MAX_THREADS // slots)
        ntiles = -(-a * c // (slots * vec))
        blocks = max(1, -(-ntiles // tiles))
        return BnPlan(vec, slots, tiles, min(blocks, 2 * SMS),
                      min(blocks, 4 * SMS))
    vec = vec if b % vec == 0 else 1
    nv = b // vec
    chunk = PLANE_THREADS * PLANE_VECTORS
    chunks = max(1, -(-nv // chunk))
    # the reduction: at least about 4 blocks an SM over all planes
    want = max(1, -(-4 * SMS // max(a * c, 1)))
    return BnPlan(vec, 0, 0, min(chunks * PLANE_VECTORS, want, 65535),
                  min(chunks, 65535))


_plan = functools.lru_cache(maxsize=512)(bn_plan)


def _layout(x: torch.Tensor) -> Tuple[torch.Tensor, int, int, int]:
    """(x in memory the kernels take, a, c, b): channels_last as rows (b =
    1), NCHW as planes (b = H*W); any other layout copied into the nearer
    of the two, and a base off 16 bytes copied to a fresh one."""
    n, c, h, w = x.shape
    rows = x.is_contiguous(memory_format=torch.channels_last) and (
        h * w == 1 or not x.is_contiguous())
    if not rows and not x.is_contiguous():
        if x.stride(1) == 1:
            x, rows = x.contiguous(memory_format=torch.channels_last), True
        else:
            x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone(memory_format=torch.channels_last if rows
                    else torch.contiguous_format)
    return (x, n * h * w, c, 1) if rows else (x, n, c, h * w)


def _like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` in x's memory layout (a no-op when it is already)."""
    fmt = (torch.channels_last if x.is_contiguous(
        memory_format=torch.channels_last) and not x.is_contiguous()
        else torch.contiguous_format)
    t = t.contiguous(memory_format=fmt)
    return t.clone(memory_format=fmt) if t.data_ptr() % 16 else t


def _vec(t: Optional[torch.Tensor],
         acc: torch.dtype) -> Optional[torch.Tensor]:
    """A per-channel vector as the kernels read it (None stays None)."""
    return None if t is None else t.detach().to(acc).contiguous()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(x: torch.Tensor, what: str) -> None:
    if x.ndim != 4:
        raise ValueError(f"{what}: x must be (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    if not x.is_cuda:
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported (float32, "
                        f"bfloat16, float64)")


# ------------------------------------------------------------ plain versions
def _finish_stats(sums, centre, running_mean, running_var, n: float,
                  unbias: float, momentum: float, update: bool):
    """The per-channel arithmetic of the statistics from the f64 sums, as
    the finishing launch does it: (2, C) [mean; biased var] in f64."""
    d, m2 = sums[0] / n, sums[1] / n
    mean = centre + d
    var = torch.clamp(m2 - d * d, min=0.0)
    if update:
        with torch.no_grad():
            running_mean.copy_((1 - momentum) * centre + momentum * mean)
            running_var.copy_((1 - momentum) * running_var.to(mean.dtype)
                              + momentum * (var * unbias))
    return torch.stack([mean, var])


def bn_moments_ref(x, centre, running_mean, running_var, *, n: float,
                   unbias: float, momentum: float, update: bool,
                   reduce: Reduce = None) -> torch.Tensor:
    """Plain version of :func:`bn_moments`."""
    acc = _acc(x.dtype)
    u = (x.to(acc) - centre.to(acc)[:, None, None]).double()
    sums = torch.stack([u.sum(dim=(0, 2, 3)), (u * u).sum(dim=(0, 2, 3))])
    if reduce is not None:
        sums = reduce(sums)
    return _finish_stats(sums, centre.double(), running_mean, running_var, n,
                         unbias, momentum, update).to(acc)


def _affine(mean, var, weight, bias, eps: float):
    rstd = 1 / torch.sqrt(var + eps)     # rounded as the kernels round it
    scale = rstd * weight.to(rstd.dtype) if weight is not None else rstd
    offset = -mean * scale if bias is None \
        else bias.to(rstd.dtype) - mean * scale
    return rstd, scale, offset


def bn_apply_ref(x, mean, var, weight, bias, eps: float) -> torch.Tensor:
    """Plain version of :func:`bn_apply`, at the kernel's rounding points:
    the product and the sum each rounded to the accumulation type, then
    the result once to x's dtype."""
    acc = _acc(x.dtype)
    _, scale, offset = _affine(mean.to(acc), var.to(acc), weight, bias, eps)
    y = x.to(acc) * scale[:, None, None] + offset[:, None, None]
    return y.to(x.dtype)


def bn_backward_ref(dy, x, mean, var, weight, eps: float, *, n: float,
                    batch_stats: bool, reduce: Reduce = None,
                    need_dx: bool = True):
    """Plain version of :func:`bn_backward`."""
    acc = _acc(x.dtype)
    rstd, scale, _ = _affine(mean.to(acc), var.to(acc), weight, None, eps)
    g, u = dy.to(acc), x.to(acc) - mean.to(acc)[:, None, None]
    sums = torch.stack([g.double().sum(dim=(0, 2, 3)),
                        (g.double() * u.double()).sum(dim=(0, 2, 3))
                        * rstd.double()])
    dx = None
    if need_dx:
        dx = scale[:, None, None] * g
        if batch_stats:
            world = reduce(sums) if reduce is not None else sums
            k_u = -scale * rstd * (world[1] / n).to(acc)
            k_0 = -scale * (world[0] / n).to(acc)
            dx = dx + (k_u[:, None, None] * u + k_0[:, None, None])
        dx = dx.to(x.dtype)
    affine = sums.to(acc)
    return dx, affine[1], affine[0]


# ------------------------------------------------------------------ kernels
def bn_moments(x, centre, running_mean, running_var, *, n: float,
               unbias: float, momentum: float, update: bool,
               reduce: Reduce = None) -> torch.Tensor:
    """The training statistics of x (N, C, H, W): a (2, C) tensor [mean;
    biased var] in f32 (f64 for f64), centred on ``centre``, over ``n``
    elements a channel (the world's count under a group, whose sums
    ``reduce`` all-reduces); the running statistics moved by ``momentum``
    toward the mean and ``var * unbias`` when ``update``. The kernels on a
    CUDA tensor, the plain version on the CPU."""
    if x.is_cpu:
        return bn_moments_ref(x, centre, running_mean, running_var, n=n,
                              unbias=unbias, momentum=momentum, update=update,
                              reduce=reduce)
    _check(x, "bn_moments")
    x, a, c, b = _layout(x)
    acc = _acc(x.dtype)
    plan = _plan(a, c, b, x.element_size())
    ctr = _vec(centre, acc)
    rm, rv = running_mean, running_var
    if update and (rm.dtype != acc or rv.dtype != acc):
        rm, rv = rm.to(acc), rv.to(acc)
    part = torch.empty((max(plan.parts(a), 1), 2 * c), dtype=torch.float64,
                       device=x.device)
    # the f64 sums under a group, to be world-summed; else the statistics
    out = torch.empty((2, c), dtype=torch.float64 if reduce else acc,
                      device=x.device)
    lib, stream = _build.library(), _build.stream(x.get_device())
    mode = _SUMS if reduce is not None else _STATS
    err = lib.esn_bn_sums(
        x.data_ptr(), None, ctr.data_ptr(), None, part.data_ptr(),
        out.data_ptr(), _ptr(rm), _ptr(rv), _DTYPE_CODES[x.dtype], a, c, b,
        *plan, mode, float(n), momentum, unbias, 0.0, int(update), stream)
    if err:
        _build.check(err, "bn_moments")
    if reduce is not None:
        sums = reduce(out)
        out = torch.empty((2, c), dtype=acc, device=x.device)
        err = lib.esn_bn_finish(
            sums.data_ptr(), 1, c, _STATS, ctr.data_ptr(), None,
            out.data_ptr(), _ptr(rm), _ptr(rv), _DTYPE_CODES[acc], float(n),
            momentum, unbias, 0.0, int(update), stream)
        if err:
            _build.check(err, "bn_moments")
    if rm is not running_mean:
        with torch.no_grad():
            running_mean.copy_(rm)
            running_var.copy_(rv)
    LAUNCHES["bn_moments"] += 1
    return out


def bn_apply(x, mean, var, weight, bias, eps: float) -> torch.Tensor:
    """``x * scale + offset`` per channel of x (N, C, H, W), with ``scale
    = rsqrt(var + eps) * weight`` and ``offset = bias - mean * scale``
    (weight and bias may be None), in f32 (f64 for f64), rounded once to
    x's dtype, in x's memory layout: the kernel on a CUDA tensor, the
    plain version on the CPU."""
    if x.is_cpu:
        return bn_apply_ref(x, mean, var, weight, bias, eps)
    _check(x, "bn_apply")
    x, a, c, b = _layout(x)
    acc = _acc(x.dtype)
    y = torch.empty_like(x)
    if y.numel():
        m, v, w, bi = (_vec(t, acc) for t in (mean, var, weight, bias))
        err = _build.library().esn_bn_apply(
            x.data_ptr(), y.data_ptr(), m.data_ptr(), v.data_ptr(), _ptr(w),
            _ptr(bi), eps, _DTYPE_CODES[x.dtype], a, c, b,
            *_plan(a, c, b, x.element_size()), _build.stream(x.get_device()))
        if err:
            _build.check(err, "bn_apply")
    LAUNCHES["bn_apply"] += 1
    return y


def bn_backward(dy, x, mean, var, weight, eps: float, *, n: float,
                batch_stats: bool, reduce: Reduce = None,
                need_dx: bool = True):
    """``(dx, dweight, dbias)`` of BN's output gradient dy: ``dweight =
    sum(dy xh)`` and ``dbias = sum(dy)`` over this rank's batch (summed in
    f64, given in f32, f64 for f64); dx in x's dtype and layout (None
    unless ``need_dx``), with the statistics' terms from the world's sums
    (``reduce``) over ``n`` when ``batch_stats``. The kernels on a CUDA
    tensor, the plain version on the CPU."""
    if x.is_cpu:
        return bn_backward_ref(dy, x, mean, var, weight, eps, n=n,
                               batch_stats=batch_stats, reduce=reduce,
                               need_dx=need_dx)
    _check(x, "bn_backward")
    x, a, c, b = _layout(x)
    dy = _like(dy, x)
    acc = _acc(x.dtype)
    plan = _plan(a, c, b, x.element_size())
    m, v, w = _vec(mean, acc), _vec(var, acc), _vec(weight, acc)
    lib, stream = _build.library(), _build.stream(x.get_device())
    code = _DTYPE_CODES[x.dtype]
    part = torch.empty((max(plan.parts(a), 1), 2 * c), dtype=torch.float64,
                       device=x.device)
    sums = torch.empty((2, c), dtype=torch.float64, device=x.device)
    err = lib.esn_bn_sums(
        x.data_ptr(), dy.data_ptr(), m.data_ptr(), v.data_ptr(),
        part.data_ptr(), sums.data_ptr(), None, None, code, a, c, b, *plan,
        _GRAD, float(n), 0.0, 0.0, eps, 0, stream)
    if err:
        _build.check(err, "bn_backward")
    dx = None
    if need_dx:
        world = None
        if batch_stats:
            world = reduce(sums) if reduce is not None else sums
        dx = torch.empty_like(x)
        if dx.numel():
            err = lib.esn_bn_dx(
                dy.data_ptr(), x.data_ptr(), dx.data_ptr(), m.data_ptr(),
                v.data_ptr(), _ptr(w), _ptr(world), float(n), eps, code, a,
                c, b, *plan, stream)
            if err:
                _build.check(err, "bn_backward")
    LAUNCHES["bn_bwd"] += 1
    affine = sums.to(acc)
    return dx, affine[1], affine[0]


class BatchNormFn(torch.autograd.Function):
    """BatchNorm of x (N, C, H, W) through :func:`bn_moments` (training:
    ``centre`` given), :func:`bn_apply` and, backward,
    :func:`bn_backward`, looked up in ``esn_tpu_torch.ops.kernels`` at
    call time; eval (``centre`` None) applies the running statistics.
    ``counts``: (n, unbias), the world's count a channel and the running
    variance's unbiased factor; ``reduce``: the world sum under a group.
    Saves x and the (2, C) statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, centre,
                eps: float, momentum: float, counts: Tuple[float, float],
                update: bool, reduce: Reduce):
        from .. import kernels
        n, unbias = counts
        if centre is None:
            stats = torch.stack([running_mean, running_var]).to(_acc(x.dtype))
        else:
            stats = kernels.bn_moments(x, centre, running_mean, running_var,
                                       n=n, unbias=unbias, momentum=momentum,
                                       update=update, reduce=reduce)
        ctx.save_for_backward(x, stats, weight)
        ctx.eps, ctx.n, ctx.reduce = eps, n, reduce
        ctx.batch_stats = centre is not None
        return kernels.bn_apply(x, stats[0], stats[1], weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        from .. import kernels
        x, stats, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dw, db = kernels.bn_backward(
            dy, x, stats[0], stats[1], weight, ctx.eps, n=ctx.n,
            batch_stats=ctx.batch_stats, reduce=ctx.reduce, need_dx=need_x)
        return (dx, dw if need_w else None, db if need_b else None,
                None, None, None, None, None, None, None, None)
