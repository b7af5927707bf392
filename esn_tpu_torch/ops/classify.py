"""Prediction-head ops (counterpart of ``esn_tpu/ops/classify.py``).

Logits here are in the reference's NHWC layout, classes last (a
``channels_last`` NCHW tensor permuted to NHWC is a free view).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..parallel import spatial
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


def _whole(what: str) -> None:
    if spatial.axis() is not None:
        raise RuntimeError(f"{what}: a prediction head takes whole images; "
                           f"predict runs outside spatial.sharded()")


def subpixel_argmax(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor], *, stride: Tuple[int, int],
                    padding: Tuple[int, int]) -> torch.Tensor:
    """Fused prediction head of a final transposed conv: the class argmax
    per subpixel phase at low resolution, the int32 indices put in place
    (``argmax(depth_to_space(z)) == depth_to_space(argmax per phase)``:
    depth-to-space only permutes pixels). The full-resolution logits never
    exist. x: NHWC features ``(N, H, W, I)``; weight ``(I, O, kh, kw)`` and
    bias the layer's. A CUDA tensor launches K7
    (``kernels.subpixel_argmax``), a CPU tensor takes its plain version."""
    _whole("subpixel_argmax")
    from .kernels import subpixel_argmax as kernel
    return kernel(x, weight, bias, stride=stride, padding=padding)


def resize2x_head_argmax(y: torch.Tensor, head: nn.Module) -> torch.Tensor:
    """Fused ``argmax(resize_bilinear_2x(head(y)))`` for a model whose 1x1
    head sits at 1/2 resolution (FPENet), y NHWC ``(B, H, W, C)``: the
    head at 1/2 (a plain conv, as the reference computes it outside
    Pallas), then the fused x2 upsample + argmax of ``resize_tail_argmax``
    (the ``resize_argmax`` kernel at r = 2), so full-resolution logits
    never exist. The reference's W-folded, premultiplied (bilinear x head)
    phase conv is work for the TPU's lanes and is not ported; its map
    equals this one up to near-ties (f32 association)."""
    _whole("resize2x_head_argmax")
    logits = head(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return resize_tail_argmax(logits, (2 * y.shape[1], 2 * y.shape[2]))
