"""LinkNet (Chaurasia & Culurciello 2017, arXiv 1707.03718); counterpart
of ``esn_tpu/models/linknet.py``.

A ResNet18-style encoder (7x7 s2 stem, 3x3 s2 max pool, four stages of
two basic blocks) and 1x1 -> 3x3 s2 transposed conv -> 1x1 decoders with
additive skips, then a 3x3 s2 transposed conv, a 3x3 conv and a 2x2 s2
transposed conv -> classes. The skips add tensors of equal size only when
H and W are multiples of 32 (CamVid's 360x480 runs at 352x480), as in the
reference. ``predict`` is the reference's fused subpixel head on ``head``
(``blocks.subpixel_predict_tail``: K7 on the card), which never builds
the full-resolution logits.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import nn as enn
from ..ops import pooling as P
from .blocks import ConvBNAct, subpixel_predict_tail
from .registry import register


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.c1 = ConvBNAct(in_ch, out_ch, 3, stride=stride, act="relu")
        self.c2 = ConvBNAct(out_ch, out_ch, 3, act="none")
        self.down = (ConvBNAct(in_ch, out_ch, 1, stride=stride, act="none")
                     if stride != 1 or in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = self.down(x) if self.down is not None else x
        return enn.relu(self.c2(self.c1(x)) + skip)


class DecoderBlock(nn.Module):
    """1x1 reduce (in/4) -> 3x3 s2 transposed conv (or a 3x3 conv) -> BN
    ReLU -> 1x1 expand."""

    def __init__(self, in_ch: int, out_ch: int, upsample: bool = True):
        super().__init__()
        mid = in_ch // 4
        self.reduce = ConvBNAct(in_ch, mid, 1, act="relu")
        self.up = (enn.ConvTranspose(mid, mid, 3, stride=2, padding=1,
                                     output_padding=1, bias=False)
                   if upsample else
                   enn.Conv(mid, mid, 3, padding=1, bias=False))
        self.up_bn = enn.BatchNorm(mid)
        self.expand = ConvBNAct(mid, out_ch, 1, act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = enn.relu(self.up_bn(self.up(self.reduce(x))))
        return self.expand(y)


@register("linknet")
class LinkNet(enn.SegModel):
    LOGITS_TAIL = "conv"
    CHS = (64, 128, 256, 512)

    def __init__(self, classes: int = 19, in_ch: int = 3):
        super().__init__()
        self.classes = classes
        self.stem = ConvBNAct(in_ch, 64, 7, stride=2, padding=3, act="relu")
        cin = 64
        for i, c in enumerate(self.CHS):
            setattr(self, f"enc{i}", nn.Sequential(
                BasicBlock(cin, c, 1 if i == 0 else 2), BasicBlock(c, c)))
            cin = c
        chs = self.CHS
        self.dec0 = DecoderBlock(chs[3], chs[2])
        self.dec1 = DecoderBlock(chs[2], chs[1])
        self.dec2 = DecoderBlock(chs[1], chs[0])
        self.dec3 = DecoderBlock(chs[0], chs[0], upsample=False)
        self.final_up = enn.ConvTranspose(64, 32, 3, stride=2, padding=1,
                                          output_padding=1, bias=False)
        self.final_bn = enn.BatchNorm(32)
        self.final_conv = ConvBNAct(32, 32, 3, act="relu")
        self.head = enn.ConvTranspose(32, classes, 2, stride=2, bias=True)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The 32-channel half-resolution features under ``head``."""
        y = P.max_pool2d(self.stem(x), 3, 2, 1)
        skips = []
        for i in range(len(self.CHS)):
            y = getattr(self, f"enc{i}")(y)
            skips.append(y)
        y = self.dec0(y) + skips[2]
        y = self.dec1(y) + skips[1]
        y = self.dec2(y) + skips[0]
        y = self.dec3(y)
        y = enn.relu(self.final_bn(self.final_up(y)))
        return self.final_conv(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """The fused subpixel head on ``head``
        (``blocks.subpixel_predict_tail``): no full-resolution logits."""
        return subpixel_predict_tail(self.head, self.features(x))
