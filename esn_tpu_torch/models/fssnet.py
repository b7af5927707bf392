"""FSSNet (Zhang et al. 2019, "Fast Semantic Segmentation Network");
counterpart of ``esn_tpu/models/fssnet.py``.

An ENet-like stem, factorized bottlenecks at 1/4, dilated bottlenecks at
1/8 (d = 2, 5, 9, twice), a transposed-conv decoder with additive encoder
skips, and a 3x3 stride-2 transposed-conv head. BN eps 1e-5, PReLU
everywhere. ``predict`` is the reference's fused subpixel head on
``head`` (``blocks.subpixel_predict_tail``: K7 on the card), which never
builds the full-resolution logits; its scanned chains are
``nn.Sequential`` (the same variable paths).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import nn as enn
from ..ops import pooling as P
from .blocks import ConvBNAct, subpixel_predict_tail
from .registry import register


def _bn_prelu(ch: int) -> nn.Sequential:
    return nn.Sequential(enn.BatchNorm(ch), enn.PReLU(ch))


class InitialBlock(nn.Module):
    """3x3 stride-2 conv (no bias) || 2x2 max pool -> concat -> BN PReLU."""

    def __init__(self, in_ch: int = 3, out_ch: int = 16):
        super().__init__()
        self.conv = enn.Conv(in_ch, out_ch - in_ch, 3, stride=2, padding=1,
                             bias=False)
        self.post = _bn_prelu(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.post(torch.cat([self.conv(x), P.max_pool2d(x, 2, 2)],
                                   dim=1))


class DownBottleneck(nn.Module):
    """2x2 stride-2 reduce -> 3x3 -> 1x1 expand, spatial dropout; the skip
    is a 2x2 max pool padded with zero channels; PReLU of the sum."""

    def __init__(self, in_ch: int, out_ch: int, dropout: float = 0.1):
        super().__init__()
        mid = out_ch // 4
        self.pad = out_ch - in_ch
        self.reduce = ConvBNAct(in_ch, mid, 2, stride=2, padding=0,
                                act="prelu")
        self.core = ConvBNAct(mid, mid, 3, act="prelu")
        self.expand = ConvBNAct(mid, out_ch, 1, act="none")
        self.drop = enn.SpatialDropout(dropout)
        self.act = enn.PReLU(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.drop(self.expand(self.core(self.reduce(x))))
        skip = P.max_pool2d(x, 2, 2)
        if self.pad > 0:
            skip = F.pad(skip, (0, 0, 0, 0, 0, self.pad))
        return self.act(y + skip)


class FactorizedBlock(nn.Module):
    """1x1 reduce -> (3x1, 1x3) -> BN PReLU -> 1x1 expand, spatial
    dropout, residual, PReLU."""

    def __init__(self, ch: int, dropout: float = 0.1):
        super().__init__()
        mid = ch // 4
        self.reduce = ConvBNAct(ch, mid, 1, act="prelu")
        self.f1 = enn.Conv(mid, mid, (3, 1), padding=(1, 0), bias=False)
        self.f2 = enn.Conv(mid, mid, (1, 3), padding=(0, 1), bias=False)
        self.mid_post = _bn_prelu(mid)
        self.expand = ConvBNAct(mid, ch, 1, act="none")
        self.drop = enn.SpatialDropout(dropout)
        self.act = enn.PReLU(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mid_post(self.f2(self.f1(self.reduce(x))))
        return self.act(x + self.drop(self.expand(y)))


class DilatedBlock(nn.Module):
    """1x1 reduce -> dilated 3x3 -> 1x1 expand, spatial dropout,
    residual, PReLU."""

    def __init__(self, ch: int, dilation: int, dropout: float = 0.1):
        super().__init__()
        mid = ch // 4
        self.reduce = ConvBNAct(ch, mid, 1, act="prelu")
        self.core = ConvBNAct(mid, mid, 3, dilation=dilation, act="prelu")
        self.expand = ConvBNAct(mid, ch, 1, act="none")
        self.drop = enn.SpatialDropout(dropout)
        self.act = enn.PReLU(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.expand(self.core(self.reduce(x)))
        return self.act(x + self.drop(y))


class UpBottleneck(nn.Module):
    """1x1 reduce -> 3x3 stride-2 transposed conv -> BN PReLU -> 1x1
    expand, spatial dropout, PReLU (no residual: the caller adds the
    encoder skip)."""

    def __init__(self, in_ch: int, out_ch: int, dropout: float = 0.1):
        super().__init__()
        mid = out_ch // 4
        self.reduce = ConvBNAct(in_ch, mid, 1, act="prelu")
        self.up = enn.ConvTranspose(mid, mid, 3, stride=2, padding=1,
                                    output_padding=1, bias=False)
        self.up_post = _bn_prelu(mid)
        self.expand = ConvBNAct(mid, out_ch, 1, act="none")
        self.drop = enn.SpatialDropout(dropout)
        self.act = enn.PReLU(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.up_post(self.up(self.reduce(x)))
        return self.act(self.drop(self.expand(y)))


@register("fssnet")
class FSSNet(enn.SegModel):
    LOGITS_TAIL = "conv"

    def __init__(self, classes: int = 19, in_ch: int = 3):
        super().__init__()
        self.classes = classes
        self.init = InitialBlock(in_ch, 16)
        self.down1 = DownBottleneck(16, 64, dropout=0.03)
        self.fac = nn.Sequential(*[FactorizedBlock(64, 0.03)
                                   for _ in range(4)])
        self.down2 = DownBottleneck(64, 128)
        self.dil = nn.Sequential(*[nn.Sequential(*[DilatedBlock(128, d)
                                                   for d in (2, 5, 9)])
                                   for _ in range(2)])
        self.up2 = UpBottleneck(128, 64)
        self.dec2 = nn.Sequential(*[FactorizedBlock(64) for _ in range(2)])
        self.up1 = UpBottleneck(64, 16)
        self.dec1 = nn.Sequential(*[FactorizedBlock(16) for _ in range(2)])
        self.head = enn.ConvTranspose(16, classes, 3, stride=2, padding=1,
                                      output_padding=1, bias=True)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The 16-channel half-resolution features under ``head``."""
        y = self.init(x)                                  # 1/2, 16
        e1 = self.fac(self.down1(y))                      # 1/4, 64
        e2 = self.dil(self.down2(e1))                     # 1/8, 128
        d2 = self.dec2(self.up2(e2) + e1)                 # 1/4, 64
        return self.dec1(self.up1(d2) + y)                # 1/2, 16

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """The fused subpixel head on ``head``
        (``blocks.subpixel_predict_tail``): no full-resolution logits."""
        return subpixel_predict_tail(self.head, self.features(x))
