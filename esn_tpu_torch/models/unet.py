"""UNet (Ronneberger et al. 2015); counterpart of ``esn_tpu/models/unet.py``.

The same-padding variant: double 3x3 conv-BN-ReLU stages under four 2x2
max pools (so the sides must be multiples of 16), and four up stages that
double the resolution (a 2x2 stride-2 transposed conv, or a bilinear x2
with ``bilinear=True``), concatenate the encoder's skip before it, and run
a double conv; a 1x1 head. ``base`` is the first stage's width (64 by
default).
"""
from __future__ import annotations

import torch
from torch import nn

from .. import nn as enn
from ..ops import pooling as P
from ..ops import resize as R
from .blocks import ConvBNAct
from .registry import register


class DoubleConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.c1 = ConvBNAct(in_ch, out_ch, 3, act="relu")
        self.c2 = ConvBNAct(out_ch, out_ch, 3, act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c2(self.c1(x))


class Up(nn.Module):
    """x2 (transposed conv to ``in_ch // 2`` channels, or bilinear), then
    ``concat([skip, x])`` and a double conv."""

    def __init__(self, in_ch: int, out_ch: int, bilinear: bool = True):
        super().__init__()
        if bilinear:
            self.up = None
            self.conv = DoubleConv(in_ch + in_ch // 2, out_ch)
        else:
            self.up = enn.ConvTranspose(in_ch, in_ch // 2, 2, stride=2,
                                        bias=True)
            self.conv = DoubleConv(in_ch, out_ch)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        if self.up is None:
            x = R.resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2))
        else:
            x = self.up(x)
        return self.conv(torch.cat([skip, x], dim=1))


@register("unet")
class UNet(enn.SegModel):
    LOGITS_TAIL = "conv"

    def __init__(self, classes: int = 19, in_ch: int = 3, base: int = 64,
                 bilinear: bool = False):
        super().__init__()
        self.classes = classes
        b = base
        self.inc = DoubleConv(in_ch, b)
        for i, (ci, co) in enumerate(((b, 2 * b), (2 * b, 4 * b),
                                      (4 * b, 8 * b), (8 * b, 16 * b))):
            setattr(self, f"down{i}", DoubleConv(ci, co))
        for i, (ci, co) in enumerate(((16 * b, 8 * b), (8 * b, 4 * b),
                                      (4 * b, 2 * b), (2 * b, b))):
            setattr(self, f"up{i}", Up(ci, co, bilinear))
        self.head = enn.Conv(b, classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.inc(x)
        feats = [y]
        for i in range(4):
            y = getattr(self, f"down{i}")(P.max_pool2d(y, 2, 2))
            feats.append(y)
        for i in range(4):
            y = getattr(self, f"up{i}")(y, feats[3 - i])
        return self.head(y)
