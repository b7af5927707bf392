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
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

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


def axis_taps(n_in: int, n_out: int, scale: float, dtype: torch.dtype):
    """torch's two source taps of each output index along an axis:
    ``(i0, i1, l0, l1)``, numpy arrays of n_out. Output d reads
    ``src = max(0, scale (d + 0.5) - 0.5)``, rounded once to the
    accumulation type (exact in f64 first: the card's fused multiply-add),
    ``i0 = floor(src)``, ``i1 = i0 + (i0 < n_in - 1)``, ``l1 = src - i0``,
    ``l0 = 1 - l1``."""
    ftype = np.float32 if _acc(dtype) == torch.float32 else np.float64
    d = np.arange(n_out, dtype=np.float64)
    src = np.maximum((scale * (d + 0.5) - 0.5).astype(ftype), ftype(0))
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
    if g.device.type == "cpu":
        return resize_bilinear_bwd_ref(g, in_hw, scales)
    if g.device.type != "cuda":
        raise ValueError(f"resize_bilinear_bwd: no kernel for device "
                         f"{g.device}")
    if g.dtype not in _DTYPE_CODES:
        raise TypeError(f"resize_bilinear_bwd: dtype {g.dtype} not "
                        f"supported (float32, bfloat16, float64)")
    if not (g.is_contiguous() or _channels_last(g)):
        g = g.contiguous()
    n, c, ho, wo = g.shape
    h, w = int(in_hw[0]), int(in_hw[1])
    gx = torch.empty((n, c, h, w), dtype=g.dtype, device=g.device,
                     memory_format=_format(g))
    if gx.numel() == 0:
        return gx
    if g.numel() == 0:
        return gx.zero_()
    host = (ctypes.c_double * 2)(*_scales((h, w), g, scales))
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = _build.library().esn_resize_bilinear_bwd(
        ctypes.c_void_p(g.data_ptr()), ctypes.c_void_p(gx.data_ptr()),
        _DTYPE_CODES[g.dtype], n, c, h, w, ho, wo, host,
        int(_channels_last(g)), ctypes.c_void_p(stream))
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
