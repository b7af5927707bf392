"""SQNet (Treml et al. 2016, "Speeding up Semantic Segmentation for
Autonomous Driving"); counterpart of ``esn_tpu/models/sqnet.py``.

A SqueezeNet-v1.1 encoder of fire modules under three 2x2 max pools,
four parallel dilated 3x3 convs (d = 1, 2, 4, 8) summed at 1/16, three
bypass-refinement stages (a 2x2 stride-2 transposed conv of the deep
path, a 3x3 of the encoder's skip, concat, 3x3 fuse) and a 2x2 stride-2
transposed-conv head. No BN: biased convs, then ReLU. ``predict`` is the
reference's fused subpixel head on ``head``
(``blocks.subpixel_predict_tail``: K7 on the card), which never builds
the full-resolution logits.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import nn as enn
from ..ops import pooling as P
from .blocks import subpixel_predict_tail
from .registry import register


class Fire(nn.Module):
    """squeeze 1x1 -> expand 1x1 || expand 3x3, each ReLU, concat."""

    def __init__(self, in_ch: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = enn.Conv(in_ch, squeeze, 1, bias=True)
        self.e1 = enn.Conv(squeeze, expand, 1, bias=True)
        self.e3 = enn.Conv(squeeze, expand, 3, padding=1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = enn.relu(self.squeeze(x))
        return torch.cat([enn.relu(self.e1(s)), enn.relu(self.e3(s))], dim=1)


class ParallelDilatedConv(nn.Module):
    """Four parallel 3x3 convs ``d0..d3`` at dilations 1, 2, 4, 8, each
    ReLU, summed."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.dilations = (1, 2, 4, 8)
        for i, d in enumerate(self.dilations):
            setattr(self, f"d{i}", enn.Conv(in_ch, out_ch, 3, padding=d,
                                            dilation=d, bias=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        total = None
        for i in range(len(self.dilations)):
            y = enn.relu(getattr(self, f"d{i}")(x))
            total = y if total is None else total + y
        return total


class BypassRefine(nn.Module):
    """Transposed conv of the deep path x2 || 3x3 refine of the skip,
    each ReLU, concat, 3x3 fuse, ReLU."""

    def __init__(self, deep_ch: int, skip_ch: int, out_ch: int):
        super().__init__()
        self.up = enn.ConvTranspose(deep_ch, out_ch, 2, stride=2, bias=True)
        self.refine = enn.Conv(skip_ch, out_ch, 3, padding=1, bias=True)
        self.fuse = enn.Conv(2 * out_ch, out_ch, 3, padding=1, bias=True)

    def forward(self, deep: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        d = enn.relu(self.up(deep))
        s = enn.relu(self.refine(skip))
        return enn.relu(self.fuse(torch.cat([d, s], dim=1)))


@register("sqnet")
class SQNet(enn.SegModel):
    LOGITS_TAIL = "conv"

    def __init__(self, classes: int = 19, in_ch: int = 3):
        super().__init__()
        self.classes = classes
        self.conv1 = enn.Conv(in_ch, 96, 3, stride=2, padding=1, bias=True)
        self.f1 = Fire(96, 16, 64)       # -> 128 (1/4 after the pool)
        self.f2 = Fire(128, 16, 64)      # -> 128
        self.f3 = Fire(128, 32, 128)     # -> 256 (1/8 after the pool)
        self.f4 = Fire(256, 32, 128)     # -> 256
        self.f5 = Fire(256, 48, 192)     # -> 384 (1/16 after the pool)
        self.f6 = Fire(384, 48, 192)     # -> 384
        self.f7 = Fire(384, 64, 256)     # -> 512
        self.f8 = Fire(512, 64, 256)     # -> 512
        self.context = ParallelDilatedConv(512, 256)
        self.r3 = BypassRefine(256, 256, 128)    # 1/16 -> 1/8, skip f4
        self.r2 = BypassRefine(128, 128, 64)     # 1/8 -> 1/4, skip f2
        self.r1 = BypassRefine(64, 96, 32)       # 1/4 -> 1/2, skip conv1
        self.head = enn.ConvTranspose(32, classes, 2, stride=2, bias=True)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The 32-channel half-resolution features under ``head``."""
        c1 = enn.relu(self.conv1(x))                              # 1/2, 96
        s4 = self.f2(self.f1(P.max_pool2d(c1, 2, 2)))             # 1/4, 128
        s8 = self.f4(self.f3(P.max_pool2d(s4, 2, 2)))             # 1/8, 256
        y = P.max_pool2d(s8, 2, 2)                                # 1/16
        y = self.context(self.f8(self.f7(self.f6(self.f5(y)))))   # 256
        return self.r1(self.r2(self.r3(y, s8), s4), c1)           # 1/2, 32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """The fused subpixel head on ``head``
        (``blocks.subpixel_predict_tail``): no full-resolution logits."""
        return subpixel_predict_tail(self.head, self.features(x))
