"""Convolution primitives (counterpart of ``esn_tpu/ops/convolution.py``).

NCHW tensors, OIHW kernels, torch's integer-padding output sizes. The
kernel and bias are cast to the input's dtype, as the reference casts its
kernel (so bf16 activations meet f32 parameters in bf16). The reference's
hand-written weight-gradient VJP is a TPU workaround and has no
counterpart here.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

IntOr2 = Union[int, Tuple[int, int]]


def conv2d(x: torch.Tensor, weight: torch.Tensor, *, stride: IntOr2 = 1,
           padding: IntOr2 = 0, dilation: IntOr2 = 1, groups: int = 1,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """2D convolution. x: NCHW, weight: OIHW (I = in_channels // groups)."""
    b = None if bias is None else bias.to(x.dtype)
    return F.conv2d(x, weight.to(x.dtype), b, stride=stride, padding=padding,
                    dilation=dilation, groups=groups)


def depthwise_conv2d(x: torch.Tensor, weight: torch.Tensor, *,
                     stride: IntOr2 = 1, padding: IntOr2 = 0,
                     dilation: IntOr2 = 1,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise conv: weight (C*multiplier, 1, kh, kw)."""
    return conv2d(x, weight, stride=stride, padding=padding,
                  dilation=dilation, groups=x.shape[1], bias=bias)


def conv2d_transpose(x: torch.Tensor, weight: torch.Tensor, *,
                     stride: IntOr2 = 1, padding: IntOr2 = 0,
                     output_padding: IntOr2 = 0,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transposed conv with torch shape semantics:
    ``out = (H - 1)*s - 2p + k + output_padding``. x: NCHW, weight:
    (in, out, kh, kw), torch's own layout: against the reference's HWIO
    kernel, which it applies as a stride-1 conv over the zero-inserted
    input, both spatial axes are flipped (``esn_tpu_torch.convert`` does
    it). The reference's subpixel and zero-insert lowerings are TPU
    workarounds and have no counterpart here."""
    b = None if bias is None else bias.to(x.dtype)
    return F.conv_transpose2d(x, weight.to(x.dtype), b, stride=stride,
                              padding=padding, output_padding=output_padding)


def conv_output_size(size: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (size + 2 * p - d * (k - 1) - 1) // s + 1
