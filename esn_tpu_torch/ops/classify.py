"""Prediction-head ops (counterpart of ``esn_tpu/ops/classify.py``).

Logits here are in the reference's NHWC layout, classes last (a
``channels_last`` NCHW tensor permuted to NHWC is a free view).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .resize import resize_bilinear


def argmax_lastdim(x: torch.Tensor) -> torch.Tensor:
    """Class-axis argmax, int32; ties go to the first maximal class."""
    return torch.argmax(x, dim=-1).to(torch.int32)


def fused_resize_argmax(y: torch.Tensor,
                        out_hw: Tuple[int, int]) -> Optional[torch.Tensor]:
    """``argmax(resize_bilinear(y.float(), out_hw))`` through the
    ``resize_argmax`` kernel, or ``None`` when the geometry is not one it
    takes: an integer, uniform scale 2 <= r <= 8 and 2 <= C <= 64."""
    n, h, w, c = y.shape
    oh, ow = out_hw
    if oh % h or ow % w or oh // h != ow // w:
        return None
    r = oh // h
    if not 2 <= r <= 8 or not 2 <= c <= 64:
        return None
    from .kernels import resize_argmax
    return resize_argmax(y.contiguous(), r)


def resize_tail_argmax(y: torch.Tensor,
                       out_hw: Tuple[int, int]) -> torch.Tensor:
    """The resize-tail prediction for NHWC logits: the fused kernel when
    eligible, else the unfused tail the model's forward ships (f32
    bilinear, cast back to the model dtype, argmax)."""
    out = fused_resize_argmax(y, out_hw)
    if out is not None:
        return out
    logits = resize_bilinear(y.permute(0, 3, 1, 2).float(), out_hw)
    return argmax_lastdim(logits.to(y.dtype).permute(0, 2, 3, 1))
