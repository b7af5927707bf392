"""Spatial sharding (counterpart of ``esn_tpu/parallel/spatial.py``): image
height sharded over the ``model`` axis of a ``(data, model)`` world of
``torch.distributed`` ranks, the vision analogue of sequence parallelism.
Full-resolution activations dominate the memory of a config-5 step
(2048x1024); sharding H splits every activation H-wise across ranks.

The reference only annotates its arrays and lets XLA's SPMD partitioner
insert the halo exchanges. Here they are written by hand:

- :func:`make_spatial_mesh` lays the world out (``parallel.mesh``): rank
  ``r`` of ``n_data x S`` at data index ``r // S``, model index
  ``r % S``; :func:`shard_batch_spatial` gives a rank its batch rows and
  its ``H / S`` image rows.
- Inside :func:`sharded` (the train step's forward and backward) the ops
  of ``esn_tpu_torch.ops`` treat their NCHW inputs as this rank's rows of
  a tensor of ``S`` equal shards: a conv, pool or resize fetches the rows
  its outputs read from the group (:func:`fetch_window`, whose backward
  returns their gradients to the rank that owns them) and runs with no H
  padding, so zeros or -inf pad only the global border; a whole-height
  reduction is summed over the group (:func:`group_sum`) and its result
  is replicated there.
- Inside :func:`replicated` (marked call sites: PPM's pooled branches,
  which pool the map :func:`whole` gives every rank of the group) the
  tensors are whole on every rank of the group: the ops run plainly,
  BatchNorm counts each element once, and a bilinear resize produces
  this rank's rows of its output, which is sharded again.

The world sums of BatchNorm's moments, the losses' normalisers, OHEM's
select and the Lovász gather, and the gradients' flat all-reduce stay
over every rank: each holds an equal piece of the global batch. With
``S = 1`` nothing here runs: :func:`sharded` enters nothing and every op
takes its plain path.

Every collective is an all-reduce over the model group in f32 or f64
(gloo has no ``all_gather`` of CUDA tensors); a row fetch writes each
owner's rows into a zero buffer, so the sum is exact.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import mesh

MAX_STRIDE = 32


def check_spatial_config(input_hw: Tuple[int, int], n_spatial: int,
                         max_stride: int = MAX_STRIDE) -> None:
    """The reference's envelope: H // max_stride >= 4 rows at the deepest
    stage, divisible by ``n_spatial``, so every shard keeps whole rows
    there. Raises the reference's ``ValueError`` otherwise."""
    h = input_hw[0]
    deep_h = h // max_stride
    if deep_h < 4 or deep_h % n_spatial != 0:
        raise ValueError(
            f"spatial sharding of H={h} over {n_spatial} shards leaves "
            f"{deep_h} rows at stride {max_stride}; need >=4 rows divisible "
            f"by {n_spatial} (use >= {max_stride * 4}px inputs)")


def check_model(model: torch.nn.Module, input_hw: Tuple[int, int],
                n_spatial: int) -> None:
    """Models with a stage deeper than the envelope's stride 32
    (``SPATIAL_DEEPEST = (stride, stage)``; LEDNet's attention pyramid
    reaches 1/64): the rows there must split into whole, equal shards.
    The reference's XLA pads such a stage; the port raises, naming the
    model, the stage and the H that works."""
    deepest = getattr(model, "SPATIAL_DEEPEST", None)
    if deepest is None or n_spatial == 1:
        return
    stride, stage = deepest
    h = input_hw[0]
    rows = h // stride
    if rows < 1 or rows % n_spatial or h % stride:
        step = stride * n_spatial
        raise ValueError(
            f"{type(model).__name__}: its {stage} works at 1/{stride}, where "
            f"H={h} leaves {rows} row(s) for spatial={n_spatial} shards; "
            f"those do not split into whole, equal rows (the reference's "
            f"XLA pads them, the port does not): use H a multiple of "
            f"{step} (e.g. H={max(step, -(-h // step) * step)})")


def make_spatial_mesh(n_data: int, n_spatial: int) -> mesh.World:
    """The ``(data, model)`` world: batch over ``data``, height over
    ``model`` (``parallel.mesh.set_spatial``). The launched world must
    hold exactly ``n_data x n_spatial`` ranks."""
    size = mesh.world().size
    if n_data * n_spatial != size:
        raise ValueError(f"a ({n_data}, {n_spatial}) mesh needs "
                         f"{n_data * n_spatial} ranks; the world has {size}")
    return mesh.set_spatial(n_spatial)


def shard_rows(x, n_spatial: int, index: int, dim: int):
    """Rows ``[index*h, (index+1)*h)`` of dim ``dim``, ``h = size /
    n_spatial`` (a numpy array or a tensor; a view)."""
    n = x.shape[dim]
    if n % n_spatial:
        raise ValueError(f"{n} rows do not split into {n_spatial} shards")
    h = n // n_spatial
    sl = [slice(None)] * x.ndim
    sl[dim] = slice(index * h, (index + 1) * h)
    return x[tuple(sl)]


def shard_batch_spatial(batch: Dict, grad_accum: int = 1,
                        w: Optional[mesh.World] = None) -> Dict:
    """This rank's batch rows (``mesh.shard_batch``, by data index) and
    its image rows: H is dim 2 of 4-d values (NCHW images) and dim 1 of
    3-d ones (NHW labels); other values pass through."""
    w = w or mesh.world()
    mine = mesh.shard_batch(batch, grad_accum, w)
    if w.spatial == 1:
        return mine
    out = {}
    for k, v in mine.items():
        nd = getattr(v, "ndim", 0)
        out[k] = shard_rows(v, w.spatial, w.model_index, 2 if nd == 4 else 1) \
            if nd in (3, 4) else v
    return out


# ------------------------------------------------------------- the contexts
@dataclasses.dataclass(frozen=True)
class Axis:
    """The model axis as an op sees it: ``size`` shards, this rank's
    ``index``, its model ``group``."""
    size: int
    index: int
    group: object


_AXIS: Optional[Axis] = None
_REPLICATED = False


@contextlib.contextmanager
def sharded() -> Iterator[None]:
    """Inside, NCHW activations are this rank's rows of tensors sharded
    over the model axis (the train step's forward and backward). Enters
    nothing with ``S = 1``."""
    global _AXIS
    w = mesh.world()
    if w.spatial == 1:
        yield
        return
    prev, _AXIS = _AXIS, Axis(w.spatial, w.model_index, mesh.model_group())
    try:
        yield
    finally:
        _AXIS = prev


@contextlib.contextmanager
def replicated() -> Iterator[None]:
    """Marks a call site whose tensors are whole on every rank of the
    model group (the output of :func:`whole` or :func:`group_sum`, e.g.
    PPM's pooled maps): ops run plainly on them, BatchNorm counts each element once, and
    ``ops.resize.resize_bilinear`` gives this rank's output rows."""
    global _REPLICATED
    if _AXIS is None:
        yield
        return
    prev, _REPLICATED = _REPLICATED, True
    try:
        yield
    finally:
        _REPLICATED = prev


def axis() -> Optional[Axis]:
    """The model axis while tensors are shards; None otherwise (no
    sharding, or inside :func:`replicated`)."""
    return None if _REPLICATED else _AXIS


def replicated_axis() -> Optional[Axis]:
    """The model axis inside :func:`replicated`; None otherwise."""
    return _AXIS if _REPLICATED else None


# -------------------------------------------------------------- collectives
def _reduce(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``t`` summed over the model group, in its wire dtype (f32 or
    f64), on the collective's device."""
    buf = t.detach().to(device=mesh._comm_device(t),
                        dtype=mesh._wire_dtype(t.dtype), copy=True)
    return mesh._all_reduce_(buf, ax.group)


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _reduce(x, ax).to(device=x.device, dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.ax).to(device=g.device, dtype=g.dtype), None


def group_sum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum of ``x`` over the model group, replicated there; the
    backward sums the ranks' upstream gradients."""
    return _GroupSum.apply(x, ax)


@dataclasses.dataclass(frozen=True)
class _Plan:
    """How the rank at ``index`` assembles its window of global rows:
    ``pieces`` in order, each ``("fill", n)``, ``("own", start, n)`` or
    ``("fetched", start, n)`` (rows of the fetched block); ``slot`` rows a
    rank in the all-reduce's buffer (0: no exchange at all), ``fetched``
    this rank's rows there, ``writes`` the ``(local start, buffer start,
    n)`` copies of its own rows into the other ranks' slots."""
    pieces: Tuple[Tuple[int, ...], ...]
    slot: int
    fetched: int
    writes: Tuple[Tuple[int, int, int], ...]


def _ranges(lo: int, hi: int, j: int, h: int, total: int):
    """Window ``[lo, hi)`` of rank ``j``: (rows above its own, its own,
    rows below its own) within ``[0, total)``, each ``(start, stop)``."""
    top = (max(lo, 0), min(hi, j * h, total))
    own = (max(lo, j * h), min(hi, (j + 1) * h))
    bottom = (max(lo, (j + 1) * h), min(hi, total))
    return [(a, max(a, b)) for a, b in (top, own, bottom)]


@functools.lru_cache(maxsize=4096)
def _plan(h: int, size: int, index: int,
          windows: Tuple[Tuple[int, int], ...]) -> _Plan:
    total = h * size
    need = []       # the global rows each rank fetches, in window order
    for j, (lo, hi) in enumerate(windows):
        top, _, bottom = _ranges(lo, hi, j, h, total)
        need.append(list(range(*top)) + list(range(*bottom)))
    slot = max(len(n) for n in need)
    writes: List[Tuple[int, int, int]] = []
    for j, rows in enumerate(need):
        for k, r in enumerate(rows):
            if r // h != index:
                continue
            start, at = r - index * h, j * slot + k
            if writes and writes[-1][0] + writes[-1][2] == start \
                    and writes[-1][1] + writes[-1][2] == at:
                writes[-1] = (writes[-1][0], writes[-1][1], writes[-1][2] + 1)
            else:
                writes.append((start, at, 1))
    lo, hi = windows[index]
    top, own, bottom = _ranges(lo, hi, index, h, total)
    ntop = top[1] - top[0]
    pieces = [("fill", max(0, min(hi, 0) - lo)), ("fetched", 0, ntop),
              ("own", own[0] - index * h, own[1] - own[0]),
              ("fetched", ntop, bottom[1] - bottom[0]),
              ("fill", max(0, hi - max(lo, total)))]
    return _Plan(tuple(p for p in pieces if p[-1] > 0), slot,
                 len(need[index]), tuple(writes))


def _like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` in ``x``'s memory format (channels_last or not), so that a
    window of rows runs the same kernels as the whole tensor would."""
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last) \
            and not x.is_contiguous():
        return t.contiguous(memory_format=torch.channels_last)
    return t


def _exchange(x: torch.Tensor, plan: _Plan, ax: Axis) -> torch.Tensor:
    """This rank's fetched rows, ``(N, C, plan.fetched, W)``: one
    all-reduce over the model group of a zero buffer of ``plan.slot``
    rows a rank, into which every owner writes the rows each rank needs."""
    n, c, _, w = x.shape
    buf = torch.zeros((n, c, ax.size * plan.slot, w),
                      dtype=mesh._wire_dtype(x.dtype),
                      device=mesh._comm_device(x))
    for a, b, k in plan.writes:
        buf[:, :, b:b + k] = x[:, :, a:a + k]
    mesh._all_reduce_(buf, ax.group)
    at = ax.index * plan.slot
    return _like(buf[:, :, at:at + plan.fetched].to(device=x.device,
                                                    dtype=x.dtype), x)


class _FetchRows(torch.autograd.Function):
    """:func:`_exchange` of ``x``; the backward sends each fetched row's
    gradient back to its owner the same way (one all-reduce) and adds it
    to the owner's rows."""

    @staticmethod
    def forward(ctx, x, plan, ax):
        ctx.plan, ctx.ax, ctx.shape = plan, ax, x.shape
        return _exchange(x, plan, ax)

    @staticmethod
    def backward(ctx, g):
        plan, ax = ctx.plan, ctx.ax
        n, c, h, w = ctx.shape
        wire = mesh._wire_dtype(g.dtype)
        buf = torch.zeros((n, c, ax.size * plan.slot, w), dtype=wire,
                          device=mesh._comm_device(g))
        at = ax.index * plan.slot
        buf[:, :, at:at + plan.fetched] = g
        mesh._all_reduce_(buf, ax.group)
        gx = torch.zeros((n, c, h, w), dtype=wire, device=buf.device)
        for a, b, k in plan.writes:
            gx[:, :, a:a + k] += buf[:, :, b:b + k]
        return gx.to(device=g.device, dtype=g.dtype), None, None


def _window(x: torch.Tensor, windows, ax: Axis, fill: float, fetch):
    windows = tuple((int(a), int(b)) for a, b in windows)
    h = x.shape[2]
    plan = _plan(h, ax.size, ax.index, windows)
    if plan.pieces == (("own", 0, h),) and plan.slot == 0:
        return x
    n, c, _, w = x.shape
    parts = []
    if plan.slot:
        # every rank of the group joins the exchange, and its backward:
        # the fetched block stays in the graph even where it is empty
        fetched = fetch(x, plan, ax)
        if not plan.fetched:
            parts.append(fetched)
    for p in plan.pieces:
        if p[0] == "fill":
            parts.append(_like(x.new_full((n, c, p[1], w), fill), x))
        elif p[0] == "own":
            parts.append(x.narrow(2, p[1], p[2]))
        else:
            parts.append(fetched.narrow(2, p[1], p[2]))
    return _like(parts[0] if len(parts) == 1 else torch.cat(parts, dim=2),
                 x)


def fetch_window(x: torch.Tensor, windows: Sequence[Tuple[int, int]],
                 ax: Axis, fill: float = 0.0) -> torch.Tensor:
    """Global rows ``[lo, hi) = windows[ax.index]`` of the tensor whose
    rows ``[index*h, (index+1)*h)`` are ``x`` (NCHW), ``fill`` outside
    ``[0, S*h)``, in ``x``'s memory format; ``windows`` holds every
    rank's window (each rank computes all of them, so all agree on the
    exchange). Rows come from any rank of the group, not only the
    adjacent ones, and their gradients go back to their owners. ``x``
    itself when the window is exactly its rows (no copy, no exchange)."""
    return _window(x, windows, ax, fill, _FetchRows.apply)


def whole(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` (NCHW, sharded over the model axis):
    the whole tensor, replicated on the group (one exchange; its backward
    returns each row's gradient to its owner). ``x`` itself while nothing
    is sharded."""
    ax = axis()
    if ax is None:
        return x
    return fetch_window(x, [(0, x.shape[2] * ax.size)] * ax.size, ax)


def gather_window(x: torch.Tensor, windows: Sequence[Tuple[int, int]],
                  ax: Axis, fill: float = 0.0) -> torch.Tensor:
    """:func:`fetch_window` without autograd (inside a Function)."""
    return _window(x, windows, ax, fill, _exchange)


# ----------------------------------------------------------------- geometry
def _split(total: int, ax: Axis, what: str) -> int:
    """The rows a shard of ``total`` output rows holds; raises where the
    shards cannot hold whole, equal rows."""
    if total % ax.size:
        raise ValueError(
            f"spatial: {what} gives {total} output rows, which "
            f"spatial={ax.size} shards cannot split into whole, equal rows; "
            f"choose an input height whose stages divide by {ax.size}")
    return total // ax.size


def stencil_windows(h: int, ax: Axis, k: int, s: int, p: int, d: int = 1
                    ) -> Tuple[Tuple[Tuple[int, int], ...], int]:
    """(every rank's input window, the output rows a rank) of a
    convolution or pool along H over ``S`` shards of ``h`` rows: kernel
    ``k``, stride ``s``, padding ``p``, dilation ``d``, floor output
    size. Output row ``o`` reads rows ``o*s - p + d*i``, ``i < k``."""
    total = (h * ax.size + 2 * p - d * (k - 1) - 1) // s + 1
    ho = _split(total, ax, f"a window of {k} rows (stride {s}, padding "
                           f"{p}, dilation {d}) over {h * ax.size} rows")
    return tuple((j * ho * s - p, (j * ho + ho - 1) * s - p + d * (k - 1) + 1)
                 for j in range(ax.size)), ho


def transpose_windows(h: int, ax: Axis, k: int, s: int, p: int, op: int
                      ) -> Tuple[Tuple[Tuple[int, int], ...], int, int]:
    """(every rank's input window, the output rows a rank, where this
    rank's rows start in the full transposed conv of its window) for a
    transposed conv along H: output row ``o`` sums input rows ``i`` with
    ``o = i*s - p + t``, ``t < k``."""
    if k < s:
        raise ValueError(f"spatial: a transposed conv with kernel {k} < "
                         f"stride {s} leaves output rows no input reads")
    total = (h * ax.size - 1) * s - 2 * p + k + op
    ho = _split(total, ax, f"a transposed conv (kernel {k}, stride {s}) "
                           f"over {h * ax.size} rows")
    wins = []
    for j in range(ax.size):
        o_lo, o_hi = j * ho, (j + 1) * ho
        wins.append((-((k - 1 - o_lo - p) // s), (o_hi - 1 + p) // s + 1))
    lo = wins[ax.index][0]
    return tuple(wins), ho, ax.index * ho + p - lo * s


def _source_rows(o: np.ndarray, scale: float, total_in: int):
    """``F.interpolate``'s two source rows of output rows ``o``
    (half-pixel, the first clamped at 0, the second at the last row)."""
    src = np.maximum(scale * (o + 0.5) - 0.5, 0.0)
    i0 = src.astype(np.int64)
    return i0, np.minimum(i0 + 1, total_in - 1)


@dataclasses.dataclass(frozen=True)
class ResizeRows:
    """The rows a bilinear resize of ``S`` shards of ``h_in`` rows to
    ``S`` shards of ``h_out`` exchanges. Forward: every rank's input
    window ``windows`` (its start a multiple of ``q``, the ratio being
    ``p/q`` in lowest terms, so the window's own half-pixel grid is the
    global one shifted by whole rows) and where this rank's output rows
    start in the window's resize (``start``). Backward: every rank's
    output rows whose gradient reaches its input rows (``grad_windows``),
    the input window those read (``grad_in``, aligned alike), where those
    output rows start in its resize (``grad_start``) and where this
    rank's own rows start in it (``own``)."""
    windows: Tuple[Tuple[int, int], ...]
    start: int
    grad_windows: Tuple[Tuple[int, int], ...]
    grad_in: Tuple[int, int]
    grad_start: int
    own: int
    ratio: float


@functools.lru_cache(maxsize=256)
def resize_rows(h_in: int, h_out: int, size: int, index: int) -> ResizeRows:
    from fractions import Fraction
    total_in, total_out = h_in * size, h_out * size
    r = Fraction(total_out, total_in)
    p, q = r.numerator, r.denominator
    scale = total_in / total_out
    i0, i1 = _source_rows(np.arange(total_out, dtype=np.float64), scale,
                          total_in)
    wins, gwins, gins = [], [], []
    for j in range(size):
        o = slice(j * h_out, (j + 1) * h_out)
        lo = int(i0[o].min()) // q * q
        wins.append((lo, max(int(i1[o].max()) + 1, (j + 1) * h_in)))
        mine = np.nonzero(((i0 >= j * h_in) & (i0 < (j + 1) * h_in))
                          | ((i1 >= j * h_in) & (i1 < (j + 1) * h_in)))[0]
        oa, ob = int(mine.min()), int(mine.max()) + 1
        glo = min(int(i0[oa:ob].min()), j * h_in) // q * q
        ghi = max(int(i1[oa:ob].max()) + 1, -(-ob * q // p), (j + 1) * h_in)
        gwins.append((oa, ob))
        gins.append((glo, min(ghi, total_in)))
    lo = wins[index][0]
    glo = gins[index][0]
    out = ResizeRows(tuple(wins), index * h_out - lo * p // q, tuple(gwins),
                     gins[index], gwins[index][0] - glo * p // q,
                     index * h_in - glo, float(r))
    if out.start < 0 or out.grad_start < 0 or out.own < 0:
        raise AssertionError(f"resize rows {out}")
    return out
