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

from ..parallel import spatial

IntOr2 = Union[int, Tuple[int, int]]


def _pair(v: IntOr2) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _cpu_bf16_row_dilated_depthwise(x: torch.Tensor, groups: int,
                                    dilation: IntOr2) -> bool:
    """Works around a defect of torch's CPU convolution: the weight
    gradient of a bf16 depthwise conv (``groups == C``) in channels_last
    memory with a row dilation above 1 comes out wrong (rel-max 1.2-1.6
    against an f64 run, NaN at d=8, at 1 thread and at 8), while the same
    conv on contiguous NCHW tensors is right (~3e-3).
    ``tests/test_torch_conv_bf16_dw.py`` holds both routes."""
    return (x.device.type == "cpu" and x.dtype == torch.bfloat16
            and groups == x.shape[1] and groups > 1
            and _pair(dilation)[0] > 1)


def conv2d(x: torch.Tensor, weight: torch.Tensor, *, stride: IntOr2 = 1,
           padding: IntOr2 = 0, dilation: IntOr2 = 1, groups: int = 1,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """2D convolution. x: NCHW, weight: OIHW (I = in_channels // groups)."""
    b = None if bias is None else bias.to(x.dtype)
    w = weight.to(x.dtype)
    ax = spatial.axis()
    if ax is None:
        return _conv2d(x, w, b, stride, padding, dilation, groups)
    (kh, _), (sh, _) = w.shape[2:], _pair(stride)
    (ph, pw), (dh, _) = _pair(padding), _pair(dilation)
    if kh > 1 or sh > 1 or ph:
        st = spatial.stencil_windows(x.shape[2], ax, kh, sh, ph, dh)
        x, rows = spatial.fetch_window(x, st.windows, ax,
                                       total=st.total), st.rows
    else:
        x, rows = spatial.nonempty(x)
    y = _conv2d(x, w, b, stride, (0, pw), dilation, groups)
    return y if y.shape[2] == rows else y.narrow(2, 0, rows)


def _conv2d(x, w, b, stride, padding, dilation, groups):
    if _cpu_bf16_row_dilated_depthwise(x, groups, dilation):
        # NCHW copies in, the result back in x's memory format. A copy,
        # not ``contiguous()``: a (C, 1, kh, kw) weight in channels_last
        # strides counts as contiguous already, and the conv would still
        # take its channels_last route
        nchw = torch.contiguous_format
        channels_last = x.is_contiguous(memory_format=torch.channels_last)
        y = F.conv2d(x.clone(memory_format=nchw), w.clone(memory_format=nchw),
                     b, stride=stride, padding=padding, dilation=dilation,
                     groups=groups)
        return (y.contiguous(memory_format=torch.channels_last)
                if channels_last else y)
    return F.conv2d(x, w, b, stride=stride, padding=padding,
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
    ax = spatial.axis()
    if ax is not None:
        (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
        oph, opw = _pair(output_padding)
        st = spatial.transpose_windows(x.shape[2], ax, weight.shape[2], sh,
                                       ph, oph)
        y = F.conv_transpose2d(
            spatial.fetch_window(x, st.windows, ax, total=st.total),
            weight.to(x.dtype), b, stride=(sh, sw), padding=(0, pw),
            output_padding=(0, opw))
        return y.narrow(2, st.start, st.rows)
    return F.conv_transpose2d(x, weight.to(x.dtype), b, stride=stride,
                              padding=padding, output_padding=output_padding)


def conv_output_size(size: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (size + 2 * p - d * (k - 1) - 1) // s + 1
