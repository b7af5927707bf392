"""Backward of the half-pixel bilinear resize in a fixed order (K5,
``csrc/resize_bilinear_bwd.cu``).

The port resizes with ``F.interpolate(mode="bilinear",
align_corners=False, antialias=False)``, the reference's
``jax.image.resize(..., antialias=False)``. torch's CUDA backward of it
adds with float atomics in no fixed order, so a training step on the card
does not repeat bit for bit; :class:`BilinearResize` keeps
``F.interpolate`` as its forward and takes :func:`resize_bilinear_bwd` as
its backward: the transpose ``A_h^T g A_w`` of the forward's map, each
input element summing its terms in one order, in f32 (f64 for f64), and
rounded once to g's dtype. ``ops.resize`` sends every differentiated
resize of a CUDA tensor through it; a CPU tensor keeps torch's own
backward, which is already fixed in order.

The map is torch's arithmetic for arithmetic (:func:`axis_scale`,
:func:`axis_taps`): another rounding of the weights would make the
backward the transpose of another map. :func:`resize_bilinear_bwd_ref`,
the plain version, builds ``A_h`` and ``A_w`` from the same formulas.

The kernel reads its taps from tables built here (:func:`axis_tables`:
each output index's first tap and two weights, each input index's run of
output indices, :func:`axis_runs`), kept on the card once per shape, and
follows a plan made here from the shapes alone (:func:`resize_plan`:
the route and its tiling). Both routes sum each input element's terms in
one order, which depends only on the terms (the header of
``csrc/resize_bilinear_bwd.cu``), so the plan moves no bit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import LAUNCHES, _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
Scales = Tuple[Optional[float], Optional[float]]


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The type the sums are taken in: f64 for f64, else f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def axis_scale(n_in: int, n_out: int, scale_factor: Optional[float],
               dtype: torch.dtype) -> float:
    """torch's ``area_pixel_compute_scale`` (``align_corners=False``):
    ``1 / scale_factor`` on the ratio route, else ``n_in / n_out``, as
    the accumulation type of ``dtype`` holds it."""
    f32 = _acc(dtype) == torch.float32
    if scale_factor is not None and scale_factor > 0:
        s = 1.0 / scale_factor
        return float(np.float32(s)) if f32 else s
    if f32:
        return float(np.float32(n_in) / np.float32(n_out))
    return n_in / n_out


def _source_f64(scale: float, n_out: int) -> np.ndarray:
    """``scale (d + 0.5) - 0.5`` for d < n_out rounded once to f64, as the
    card's fused multiply-add takes it: exact in integers (``scale`` is
    num / den with den a power of two), then one correctly rounded
    division."""
    num, den = float(scale).as_integer_ratio()
    return np.array([(num * (2 * d + 1) - den) / (2 * den)
                     for d in range(n_out)], dtype=np.float64)


def axis_taps(n_in: int, n_out: int, scale: float, dtype: torch.dtype):
    """torch's two source taps of each output index along an axis:
    ``(i0, i1, l0, l1)``, numpy arrays of n_out. Output d reads
    ``src = max(0, scale (d + 0.5) - 0.5)``, rounded once to the
    accumulation type (the card's fused multiply-add: exact in f64 and
    rounded to f32, or exact in integers and rounded to f64),
    ``i0 = floor(src)``, ``i1 = i0 + (i0 < n_in - 1)``, ``l1 = src - i0``,
    ``l0 = 1 - l1``."""
    ftype = np.float32 if _acc(dtype) == torch.float32 else np.float64
    if ftype == np.float32:
        d = np.arange(n_out, dtype=np.float64)
        src = (scale * (d + 0.5) - 0.5).astype(ftype)
    else:
        src = _source_f64(scale, n_out)
    src = np.maximum(src, ftype(0))
    i0 = src.astype(np.int64)
    l1 = src - i0.astype(ftype)
    l0 = ftype(1) - l1
    i1 = i0 + (i0 < n_in - 1)
    return i0, i1, l0, l1


def axis_matrix(n_in: int, n_out: int, scale: float,
                dtype: torch.dtype) -> np.ndarray:
    """The forward's map along an axis, (n_out, n_in): row d holds l0 at
    i0 and l1 at i1 (their sum where the two coincide)."""
    i0, i1, l0, l1 = axis_taps(n_in, n_out, scale, dtype)
    a = np.zeros((n_out, n_in), l0.dtype)
    rows = np.arange(n_out)
    np.add.at(a, (rows, i0), l0)
    np.add.at(a, (rows, i1), l1)
    return a


def axis_runs(i0: np.ndarray, n_in: int) -> Tuple[np.ndarray, np.ndarray]:
    """Each input index's run of output indices, ``[lo[i], hi[i])``:
    those whose taps read i, ``i0 in {i - 1, i}`` (i0 never falls along
    the axis). The run is the order in which the kernel sums i's terms."""
    i = np.arange(n_in)
    return (np.searchsorted(i0, i - 1, side="left"),
            np.searchsorted(i0, i + 1, side="left"))


class AxisTables(NamedTuple):
    """What the kernel reads of one axis: ``taps`` (int32) is i0 of each
    output index, then lo and hi of each input index (:func:`axis_runs`);
    ``weights`` (the accumulation type) is l0, then l1, of each output
    index (:func:`axis_taps`)."""
    taps: np.ndarray
    weights: np.ndarray


def axis_tables(n_in: int, n_out: int, scale: float,
                dtype: torch.dtype) -> AxisTables:
    i0, _, l0, l1 = axis_taps(n_in, n_out, scale, dtype)
    lo, hi = axis_runs(i0, n_in)
    return AxisTables(np.concatenate([i0, lo, hi]).astype(np.int32),
                      np.concatenate([l0, l1]))


def table_runs(t: AxisTables, n_in: int, n_out: int):
    """(lo, hi) of each input index, as ``t.taps`` holds them."""
    return t.taps[n_out:n_out + n_in], t.taps[n_out + n_in:]


_tables = functools.lru_cache(maxsize=64)(axis_tables)


@functools.lru_cache(maxsize=64)
def _device_tables(n_in: int, n_out: int, scale: float, dtype: torch.dtype,
                   device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`axis_tables` on the card, copied there once per shape."""
    t = _tables(n_in, n_out, scale, dtype)
    return (torch.from_numpy(t.taps).to(device),
            torch.from_numpy(t.weights).to(device))


# The plan. The streaming route: a block per (plane, band of ti input
# rows, band of tj input columns), STREAM_THREADS threads each holding at
# most STREAM_ITEMS (column, value) items of the band, a staged output
# row at most STAGE_MAX bytes; taken where the input has at least
# STREAM_MIN_INPUTS elements and such a band fits. The fan-in route
# otherwise: a block per (input pixel, `lines` lines), `lanes` lanes a
# line. SMS, the H100's count of multiprocessors, sizes the grid only.
STREAM, FANIN = 0, 1
STREAM_THREADS, STREAM_ITEMS, STREAM_STAGES = 256, 4, 3
STAGE_MAX = 24 * 1024
STREAM_MIN_INPUTS = 1 << 16
FANIN_THREADS = 256
SMEM_MAX = 227 * 1024
SMS = 132


class ResizePlan(NamedTuple):
    """What :func:`resize_plan` hands the kernel, in this order."""
    route: int
    ti: int          # streaming: input rows a block
    tj: int          # streaming: input columns a block
    stage: int       # streaming: bytes of one staged output row
    wmax: int        # the longest run along W (the block's weight table)
    lanes: int       # fan-in: lanes a line
    lines: int       # fan-in: lines a block
    smem: int        # dynamic shared memory, bytes


def _pow2_at_most(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def resize_plan(n: int, c: int, h: int, w: int, channels_last: bool,
                itemsize: int, acc_itemsize: int, runs_h, runs_w,
                route: Optional[int] = None) -> ResizePlan:
    """The kernel's route and tiling for a g of (n, c, *) and an input of
    (h, w), from the shapes and the runs (:func:`axis_runs`) alone. In
    channels_last a line is a channel of an image and a pixel holds
    ``c`` values; in NCHW a line is a plane and a pixel one value.
    ``route`` (STREAM or FANIN) takes that route whatever the size (the
    two give the same bits); a band that does not fit raises."""
    lo_h, hi_h = runs_h
    lo_w, hi_w = runs_w
    vals = c if channels_last else 1
    planes = n if channels_last else n * c
    hmax = max(1, int((hi_h - lo_h).max()))
    wmax = max(1, int((hi_w - lo_w).max()))

    def stage(tj):
        # the widest band's output columns, all its values, and up to 15
        # bytes before them to start on a 16-byte boundary
        ja = np.arange(0, w, tj)
        jb = np.minimum(ja + tj, w) - 1
        cols = int((hi_w[jb] - lo_w[ja]).max())
        return -(-(cols * vals * itemsize + 15) // 16) * 16

    if route == STREAM or (route is None
                           and n * c * h * w >= STREAM_MIN_INPUTS):
        for tj in [w] + [1 << k for k in range(w.bit_length() - 1, -1, -1)
                         if 1 << k < w]:
            st = stage(tj)
            smem = STREAM_STAGES * st + tj * wmax * acc_itemsize + 8 * tj
            if (tj * vals <= STREAM_THREADS * STREAM_ITEMS
                    and st <= STAGE_MAX and smem <= SMEM_MAX):
                ti = _pow2_at_most(min(h, 32))
                while ti > 1 and planes * -(-h // ti) * -(-w // tj) < SMS:
                    ti //= 2
                return ResizePlan(STREAM, ti, tj, st, wmax, 0, 0, smem)
        if route == STREAM:
            raise ValueError("resize_bilinear_bwd: no band of the streaming "
                             "route fits")
    lanes = min(32, 1 << (hmax - 1).bit_length())
    lines = FANIN_THREADS // lanes
    smem = wmax * acc_itemsize + lines * lanes * acc_itemsize
    if smem > SMEM_MAX:
        raise ValueError(f"resize_bilinear_bwd: a run of {wmax} output "
                         f"columns does not fit a block's shared memory")
    return ResizePlan(FANIN, 0, 0, 0, wmax, lanes, lines, smem)


def _channels_last(t: torch.Tensor) -> bool:
    """NHWC in memory (a tensor contiguous both ways counts as NCHW: the
    two orders are then the same)."""
    return (t.is_contiguous(memory_format=torch.channels_last)
            and not t.is_contiguous())


def _format(t: torch.Tensor):
    return (torch.channels_last if _channels_last(t)
            else torch.contiguous_format)


def _scales(in_hw, g, scales: Optional[Sequence[Optional[float]]]):
    sh, sw = scales if scales is not None else (None, None)
    return (axis_scale(in_hw[0], g.shape[2], sh, g.dtype),
            axis_scale(in_hw[1], g.shape[3], sw, g.dtype))


def resize_bilinear_bwd_ref(g: torch.Tensor, in_hw: Tuple[int, int],
                            scales: Optional[Scales] = None) -> torch.Tensor:
    """Plain version: ``A_h^T g A_w`` in the accumulation type, cast to
    g's dtype, in g's memory format. ``scales``: the (H, W) scale factors
    of the forward's ratio route, or None for its size route."""
    h, w = in_hw
    sh, sw = _scales(in_hw, g, scales)
    acc = _acc(g.dtype)
    a_h = torch.from_numpy(axis_matrix(h, g.shape[2], sh, g.dtype))
    a_w = torch.from_numpy(axis_matrix(w, g.shape[3], sw, g.dtype))
    gx = (a_h.to(g.device, acc).t() @ g.to(acc)) @ a_w.to(g.device, acc)
    return gx.to(g.dtype).contiguous(memory_format=_format(g))


def resize_bilinear_bwd(g: torch.Tensor, in_hw: Tuple[int, int],
                        scales: Optional[Scales] = None) -> torch.Tensor:
    """The gradient of the bilinear resize of an (N, C, *in_hw) input,
    given the output's gradient g: the kernel for a CUDA tensor, the plain
    version on the CPU."""
    if g.ndim != 4 or len(in_hw) != 2:
        raise ValueError(f"resize_bilinear_bwd: g {tuple(g.shape)}, in_hw "
                         f"{tuple(in_hw)}")
    if g.is_cpu:
        return resize_bilinear_bwd_ref(g, in_hw, scales)
    if not g.is_cuda:
        raise ValueError(f"resize_bilinear_bwd: no kernel for device "
                         f"{g.device}")
    if g.dtype not in _DTYPE_CODES:
        raise TypeError(f"resize_bilinear_bwd: dtype {g.dtype} not "
                        f"supported (float32, bfloat16, float64)")
    cl = _channels_last(g)
    if not (cl or g.is_contiguous()):
        g = g.contiguous()
    n, c, ho, wo = g.shape
    h, w = int(in_hw[0]), int(in_hw[1])
    if n * c * h * w == 0 or g.numel() == 0:
        return torch.zeros((n, c, h, w), dtype=g.dtype, device=g.device,
                           memory_format=torch.channels_last if cl
                           else torch.contiguous_format)
    call = _call(tuple(g.shape), (h, w), g.dtype, cl,
                 None if scales is None else tuple(scales), g.get_device())
    return _launch(g, g.new_empty_strided((n, c, h, w), call.strides), call)


class _Call(NamedTuple):
    """A launch for one shape: the plan, the descriptor the C function
    reads (int64: dtype code, n, c, h, w, ho, wo, channels_last, the four
    table pointers, the plan's ints) and its address, the tables it
    points into, kept alive here, and gx's strides."""
    plan: ResizePlan
    desc: object
    address: int
    tables: tuple
    strides: tuple   # gx's, in g's memory format


@functools.lru_cache(maxsize=256)
def _call(shape, in_hw, dtype, channels_last, scales, device: int,
          route: Optional[int] = None) -> _Call:
    """The launch of K5 for g of ``shape`` on card ``device``: the plan's
    route, or ``route`` (the card tests run both routes on one input)."""
    n, c, ho, wo = shape
    h, w = in_hw
    sh, sw = (axis_scale(h, ho, None if scales is None else scales[0], dtype),
              axis_scale(w, wo, None if scales is None else scales[1], dtype))
    plan = resize_plan(
        n, c, h, w, channels_last, torch.empty((), dtype=dtype).element_size(),
        torch.empty((), dtype=_acc(dtype)).element_size(),
        table_runs(_tables(h, ho, sh, dtype), h, ho),
        table_runs(_tables(w, wo, sw, dtype), w, wo), route)
    th = _device_tables(h, ho, sh, dtype, f"cuda:{device}")
    tw = _device_tables(w, wo, sw, dtype, f"cuda:{device}")
    fields = (_DTYPE_CODES[dtype], n, c, h, w, ho, wo, int(channels_last),
              th[0].data_ptr(), th[1].data_ptr(), tw[0].data_ptr(),
              tw[1].data_ptr(), *plan)
    desc = (ctypes.c_int64 * len(fields))(*fields)
    strides = (c * h * w, 1, w * c, c) if channels_last else (
        c * h * w, h * w, w, 1)
    return _Call(plan, desc, ctypes.addressof(desc), (th, tw), strides)


def _launch(g: torch.Tensor, gx: torch.Tensor, call: _Call) -> torch.Tensor:
    """K5 on g into gx as ``call`` says."""
    if g.data_ptr() % 16:
        g = g.clone()       # the staging copies 16-byte words of g
    err = _build.library().esn_resize_bilinear_bwd(
        g.data_ptr(), gx.data_ptr(), call.address,
        _build.stream(g.get_device()))
    if err:
        _build.check(err, "resize_bilinear_bwd")
    LAUNCHES["resize_bilinear_bwd"] += 1
    return gx


class BilinearResize(torch.autograd.Function):
    """``F.interpolate`` (bilinear, half-pixel, no antialias) to ``size``
    or by ``scale_factor`` (torch's ``recompute_scale_factor=False``
    route), whose backward is :func:`resize_bilinear_bwd`, looked up in
    ``esn_tpu_torch.ops.kernels`` at call time."""

    @staticmethod
    def forward(ctx, x, size, scale_factor):
        ctx.in_hw = tuple(x.shape[2:])
        ctx.scales = (None if scale_factor is None
                      else tuple(float(s) for s in scale_factor))
        return F.interpolate(
            x, size=size, scale_factor=scale_factor, mode="bilinear",
            align_corners=False, antialias=False,
            recompute_scale_factor=False if scale_factor is not None
            else None)

    @staticmethod
    def backward(ctx, g):
        from .. import kernels
        gx = kernels.resize_bilinear_bwd(g, ctx.in_hw, ctx.scales)
        return gx, None, None
