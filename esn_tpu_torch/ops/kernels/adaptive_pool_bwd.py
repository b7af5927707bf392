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
"""
from __future__ import annotations

import ctypes
from typing import Tuple

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
    if g.device.type == "cpu":
        return adaptive_pool_bwd_ref(g, in_hw)
    if g.device.type != "cuda":
        raise ValueError(f"adaptive_pool_bwd: no kernel for device "
                         f"{g.device}")
    if g.dtype not in _DTYPE_CODES:
        raise TypeError(f"adaptive_pool_bwd: dtype {g.dtype} not supported "
                        f"(float32, bfloat16, float64)")
    if not (g.is_contiguous() or _channels_last(g)):
        g = g.contiguous()
    n, c, oh, ow = g.shape
    h, w = int(in_hw[0]), int(in_hw[1])
    gx = torch.empty((n, c, h, w), dtype=g.dtype, device=g.device,
                     memory_format=_format(g))
    if gx.numel() == 0:
        return gx
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = _build.library().esn_adaptive_pool_bwd(
        ctypes.c_void_p(g.data_ptr()), ctypes.c_void_p(gx.data_ptr()),
        _DTYPE_CODES[g.dtype], n, c, h, w, oh, ow, int(_channels_last(g)),
        ctypes.c_void_p(stream))
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
