"""Backward of the adaptive average pool in a fixed order (K6,
``csrc/adaptive_pool_bwd.cu``).

The port pools with ``F.adaptive_avg_pool2d`` (PPM's pool; the
reference's bin edges). torch's CUDA backward of it adds with float
atomics in no fixed order; :class:`AdaptiveAvgPool` keeps the forward and
takes :func:`adaptive_pool_bwd` as its backward: each input element sums
``g / kh / kw`` over the bins that hold it, in one order, in f32 (f64 for
f64), rounded once to g's dtype. ``ops.pooling`` sends every
differentiated adaptive pool of a CUDA tensor through it; a CPU tensor
keeps torch's own backward. :func:`adaptive_pool_bwd_ref` is the plain
version.

The kernel reads the bins from tables built here (:func:`pool_tables`:
the first bin and the count of bins that hold each index, and each bin's
size), kept on the card once per shape, and follows a plan made here from
the shapes alone (:func:`pool_plan`); neither moves the order of a sum.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import LAUNCHES, _build
from .resize_bilinear_bwd import _DTYPE_CODES, _acc, _channels_last, _format


def pool_bins(length: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(starts, ends) of the n bins over ``length``: bin a spans
    ``[floor(a L / n), ceil((a + 1) L / n))``."""
    a = np.arange(n, dtype=np.int64)
    return (a * length) // n, -((-(a + 1) * length) // n)


def pool_tables(length: int, n: int) -> np.ndarray:
    """What the kernel reads of one axis (int32): the first bin that holds
    each of the ``length`` indices, the count of bins that hold it (they
    follow the first), and each bin's size."""
    start, end = pool_bins(length, n)
    holds = _membership(length, n) > 0
    return np.concatenate([holds.argmax(axis=0), holds.sum(axis=0),
                           end - start]).astype(np.int32)


class PoolPlan(NamedTuple):
    """What :func:`pool_plan` hands the kernel, in this order: a block
    owns one image's input row, ``xb`` columns and ``cb`` channels;
    ``vec`` channels a thread (16 bytes, channels_last) or 1; ``nbb``, the
    most bins of columns a block holds; ``smem`` bytes of bin values."""
    xb: int
    cb: int
    vec: int
    nbb: int
    smem: int


SMEM_BUDGET = 48 * 1024


def pool_plan(c: int, w: int, channels_last: bool, itemsize: int,
              acc_itemsize: int, tables_h: np.ndarray, tables_w: np.ndarray,
              h: int) -> PoolPlan:
    """The kernel's tiling, from the shapes and tables alone: all columns
    and channels of a row where their bin values fit SMEM_BUDGET, else
    fewer channels, then fewer columns."""
    na = int(tables_h[h:2 * h].max())
    first, count = tables_w[:w], tables_w[w:2 * w]
    per = 16 // itemsize
    vec = per if channels_last and c % per == 0 else 1

    def nbb(xb):
        xa = np.arange(0, w, xb)
        xe = np.minimum(xa + xb, w) - 1
        return int((first[xe] + count[xe] - first[xa]).max())

    xb, cb = w, c
    while na * nbb(xb) * cb * acc_itemsize > SMEM_BUDGET:
        if cb > vec:
            cb = max(vec, cb // 2 // vec * vec)
        elif xb > 1:
            xb = (xb + 1) // 2
        else:
            raise ValueError("adaptive_pool_bwd: a bin's values do not fit "
                             "a block's shared memory")
    return PoolPlan(xb, cb, vec, nbb(xb), na * nbb(xb) * cb * acc_itemsize)


_tables = functools.lru_cache(maxsize=64)(pool_tables)


@functools.lru_cache(maxsize=64)
def _device_tables(length: int, n: int, device: str) -> torch.Tensor:
    """:func:`pool_tables` on the card, copied there once per shape."""
    return torch.from_numpy(_tables(length, n)).to(device)


@functools.lru_cache(maxsize=256)
def _desc(n, c, h, w, oh, ow, channels_last, dtype, device: int) -> tuple:
    """The descriptor the C function reads for one shape on card
    ``device`` (int64: dtype code, n, c, h, w, oh, ow, channels_last, the
    two tables' pointers, the plan's ints), its address, the tables it
    points into, kept alive here, and gx's strides."""
    plan = pool_plan(c, w, channels_last,
                     torch.empty((), dtype=dtype).element_size(),
                     torch.empty((), dtype=_acc(dtype)).element_size(),
                     _tables(h, oh), _tables(w, ow), h)
    th = _device_tables(h, oh, f"cuda:{device}")
    tw = _device_tables(w, ow, f"cuda:{device}")
    fields = (_DTYPE_CODES[dtype], n, c, h, w, oh, ow, int(channels_last),
              th.data_ptr(), tw.data_ptr(), *plan)
    desc = (ctypes.c_int64 * len(fields))(*fields)
    strides = (c * h * w, 1, w * c, c) if channels_last else (
        c * h * w, h * w, w, 1)
    return desc, ctypes.addressof(desc), (th, tw), strides


def _membership(length: int, n: int) -> np.ndarray:
    """(n, length): 1 where bin a holds index i."""
    start, end = pool_bins(length, n)
    i = np.arange(length)
    return ((i >= start[:, None]) & (i < end[:, None])).astype(np.float64)


def adaptive_pool_bwd_ref(g: torch.Tensor, in_hw: Tuple[int, int]
                          ) -> torch.Tensor:
    """Plain version: each bin's ``g / kh / kw`` (the two divisions in the
    accumulation type) spread over its elements, ``P_h^T v P_w``, cast to
    g's dtype, in g's memory format."""
    h, w = in_hw
    oh, ow = g.shape[2], g.shape[3]
    acc = _acc(g.dtype)
    s_h, e_h = pool_bins(h, oh)
    s_w, e_w = pool_bins(w, ow)
    kh = torch.from_numpy(e_h - s_h).to(g.device, acc)
    kw = torch.from_numpy(e_w - s_w).to(g.device, acc)
    v = g.to(acc) / kh[:, None] / kw
    p_h = torch.from_numpy(_membership(h, oh)).to(g.device, acc)
    p_w = torch.from_numpy(_membership(w, ow)).to(g.device, acc)
    gx = (p_h.t() @ v) @ p_w
    return gx.to(g.dtype).contiguous(memory_format=_format(g))


def adaptive_pool_bwd(g: torch.Tensor, in_hw: Tuple[int, int]
                      ) -> torch.Tensor:
    """The gradient of the adaptive average pool of an (N, C, *in_hw)
    input to g's (oh, ow), given the output's gradient g: the kernel for a
    CUDA tensor, the plain version on the CPU."""
    if g.ndim != 4 or len(in_hw) != 2:
        raise ValueError(f"adaptive_pool_bwd: g {tuple(g.shape)}, in_hw "
                         f"{tuple(in_hw)}")
    if g.is_cpu:
        return adaptive_pool_bwd_ref(g, in_hw)
    if not g.is_cuda:
        raise ValueError(f"adaptive_pool_bwd: no kernel for device "
                         f"{g.device}")
    if g.dtype not in _DTYPE_CODES:
        raise TypeError(f"adaptive_pool_bwd: dtype {g.dtype} not supported "
                        f"(float32, bfloat16, float64)")
    cl = _channels_last(g)
    if not (cl or g.is_contiguous()):
        g = g.contiguous()
    n, c, oh, ow = g.shape
    h, w = int(in_hw[0]), int(in_hw[1])
    if n * c * h * w == 0:
        return torch.empty((n, c, h, w), dtype=g.dtype, device=g.device,
                           memory_format=torch.channels_last if cl
                           else torch.contiguous_format)
    device = g.get_device()
    _, address, _, strides = _desc(n, c, h, w, oh, ow, cl, g.dtype, device)
    gx = g.new_empty_strided((n, c, h, w), strides)
    err = _build.library().esn_adaptive_pool_bwd(
        g.data_ptr(), gx.data_ptr(), address, _build.stream(device))
    if err:
        _build.check(err, "adaptive_pool_bwd")
    LAUNCHES["adaptive_pool_bwd"] += 1
    return gx


class AdaptiveAvgPool(torch.autograd.Function):
    """``F.adaptive_avg_pool2d`` whose backward is
    :func:`adaptive_pool_bwd`, looked up in ``esn_tpu_torch.ops.kernels``
    at call time."""

    @staticmethod
    def forward(ctx, x, output_size):
        ctx.in_hw = tuple(x.shape[2:])
        return F.adaptive_avg_pool2d(x, output_size)

    @staticmethod
    def backward(ctx, g):
        from .. import kernels
        return kernels.adaptive_pool_bwd(g, ctx.in_hw), None
