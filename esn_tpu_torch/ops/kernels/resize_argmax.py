"""Fused bilinear-upsample + class-argmax prediction tail (counterpart of
``esn_tpu/ops/pallas/resize_argmax.py``).

``argmax_c(upsample_bilinear_xr(y))`` -> (B, r*h, r*w) int32 with the
first-max tie rule, for low-res logits y ``(B, h, w, C)`` (the reference's
NHWC). On CUDA it is the kernel of ``csrc/resize_argmax.cu``, which
argmaxes the f32 interpolation; on the CPU the plain
:func:`resize_argmax_ref`, the unfused tail the models ship (f32 upsample,
cast back to y's dtype, argmax). In bf16 the two can differ at pixels
where that cast creates or breaks a tie.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import LAUNCHES, _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_FACTOR = 8


def resize_argmax_ref(y: torch.Tensor, factor: int) -> torch.Tensor:
    """Plain version: the unfused tail."""
    n, h, w, c = y.shape
    up = F.interpolate(y.permute(0, 3, 1, 2).float(),
                       size=(h * factor, w * factor), mode="bilinear",
                       align_corners=False, antialias=False)
    return torch.argmax(up.to(y.dtype), dim=1).to(torch.int32)


def resize_argmax(y: torch.Tensor, factor: int) -> torch.Tensor:
    """Fused ``argmax(upsample_bilinear_xr(y))`` for y (B, h, w, C)."""
    r = int(factor)
    if y.ndim != 4 or not 1 <= r <= MAX_FACTOR:
        raise ValueError(f"resize_argmax: y {tuple(y.shape)}, factor {factor}")
    if y.device.type == "cpu":
        return resize_argmax_ref(y, r)
    if y.device.type != "cuda":
        raise ValueError(f"resize_argmax: no kernel for device {y.device}")
    if y.dtype not in _DTYPE_CODES:
        raise TypeError(f"resize_argmax: dtype {y.dtype} not supported "
                        f"(float32, bfloat16)")
    if not y.is_contiguous():
        raise ValueError("resize_argmax: y must be contiguous NHWC")
    n, h, w, c = y.shape
    out = torch.empty((n, h * r, w * r), dtype=torch.int32, device=y.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = _build.library().esn_resize_argmax(
        ctypes.c_void_p(y.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        _DTYPE_CODES[y.dtype], n, h, w, c, r, ctypes.c_void_p(stream))
    _build.check(err, "resize_argmax")
    LAUNCHES["resize_argmax"] += 1
    return out
