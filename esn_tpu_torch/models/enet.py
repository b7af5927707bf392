"""ENet (Paszke et al. 2016, arXiv 1606.02147); counterpart of
``esn_tpu/models/enet.py``.

Architecture (the paper's Table 1):

- initial: 3x3/s2 conv (13 ch) || 2x2 max pool (3 ch) -> concat, 16 ch
- stage1: downsample 16 -> 64 + 4 regular bottlenecks (dropout 0.01)
- stage2: downsample 64 -> 128 + [regular, dilated 2, asymmetric 5,
  dilated 4, regular, dilated 8, asymmetric 5, dilated 16] (dropout 0.1)
- stage3: the stage2 mix again, no downsample
- stage4: upsample 128 -> 64 (max-unpool skip) + 2 regular, ReLU decoder
- stage5: upsample 64 -> 16 + 1 regular
- fullconv: 3x3/s2 transposed conv -> classes, at the input's resolution

The encoder's max-pool positions reach the decoder as values: a
downsampling bottleneck returns ``(out, indices)`` and the matching
upsampling bottleneck takes the indices (``ops.pooling``). The
reference's space-to-depth stem, lane-folded bottlenecks and fused
subpixel prediction head are TPU layout work and have no counterpart:
``predict`` is the argmax of the full-resolution logits.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import nn as enn
from ..ops import pooling as P
from .registry import register


def _act(relu: bool, ch: int) -> nn.Module:
    return nn.ReLU() if relu else enn.PReLU(ch)


class InitialBlock(nn.Module):
    def __init__(self, in_ch: int = 3, out_ch: int = 16):
        super().__init__()
        self.conv = enn.Conv(in_ch, out_ch - in_ch, 3, stride=2, padding=1,
                             bias=False)
        self.bn = enn.BatchNorm(out_ch)
        self.act = enn.PReLU(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([self.conv(x), P.max_pool2d(x, 2, 2)], dim=1)
        return self.act(self.bn(y))


class RegularBottleneck(nn.Module):
    """Residual bottleneck: 1x1 reduce -> core conv -> 1x1 expand.

    ``dilation`` > 1 selects the dilated variant; ``asymmetric`` the
    5x1 + 1x5 factorised core.
    """

    def __init__(self, ch: int, *, internal_ratio: int = 4, dilation: int = 1,
                 asymmetric: bool = False, dropout: float = 0.1,
                 relu: bool = False):
        super().__init__()
        self.ch = ch
        mid = ch // internal_ratio
        self.reduce = nn.Sequential(enn.Conv(ch, mid, 1, bias=False),
                                    enn.BatchNorm(mid), _act(relu, mid))
        if asymmetric:
            self.core = nn.Sequential(
                enn.Conv(mid, mid, (5, 1), padding=(2, 0), bias=False),
                enn.Conv(mid, mid, (1, 5), padding=(0, 2), bias=False),
                enn.BatchNorm(mid), _act(relu, mid))
        else:
            self.core = nn.Sequential(
                enn.Conv(mid, mid, 3, padding=dilation, dilation=dilation,
                         bias=False),
                enn.BatchNorm(mid), _act(relu, mid))
        self.expand = nn.Sequential(enn.Conv(mid, ch, 1, bias=False),
                                    enn.BatchNorm(ch))
        self.drop = enn.SpatialDropout(dropout)
        self.out_act = _act(relu, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.drop(self.expand(self.core(self.reduce(x))))
        return self.out_act(x + y)


class DownsamplingBottleneck(nn.Module):
    """Strided bottleneck; skip = indexed 2x2 max pool with zero channels
    appended. Returns ``(out, indices)``."""

    def __init__(self, in_ch: int, out_ch: int, *, internal_ratio: int = 4,
                 dropout: float = 0.1, relu: bool = False):
        super().__init__()
        mid = in_ch // internal_ratio
        self.in_ch, self.out_ch = in_ch, out_ch
        self.reduce = nn.Sequential(
            enn.Conv(in_ch, mid, 2, stride=2, bias=False),
            enn.BatchNorm(mid), _act(relu, mid))
        self.core = nn.Sequential(
            enn.Conv(mid, mid, 3, padding=1, bias=False),
            enn.BatchNorm(mid), _act(relu, mid))
        self.expand = nn.Sequential(enn.Conv(mid, out_ch, 1, bias=False),
                                    enn.BatchNorm(out_ch))
        self.drop = enn.SpatialDropout(dropout)
        self.out_act = _act(relu, out_ch)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        main = self.drop(self.expand(self.core(self.reduce(x))))
        skip, indices = P.max_pool2d_with_indices_2x2(x)
        pad = self.out_ch - self.in_ch
        if pad > 0:
            skip = F.pad(skip, (0, 0, 0, 0, 0, pad))
        return self.out_act(main + skip), indices


class UpsamplingBottleneck(nn.Module):
    """Transposed-conv bottleneck; skip = 1x1 conv + BN, then max-unpool
    with the encoder's indices."""

    def __init__(self, in_ch: int, out_ch: int, *, internal_ratio: int = 4,
                 dropout: float = 0.1, relu: bool = True):
        super().__init__()
        mid = in_ch // internal_ratio
        self.skip_conv = nn.Sequential(enn.Conv(in_ch, out_ch, 1, bias=False),
                                       enn.BatchNorm(out_ch))
        self.reduce = nn.Sequential(enn.Conv(in_ch, mid, 1, bias=False),
                                    enn.BatchNorm(mid), _act(relu, mid))
        self.up = nn.Sequential(
            enn.ConvTranspose(mid, mid, 3, stride=2, padding=1,
                              output_padding=1, bias=False),
            enn.BatchNorm(mid), _act(relu, mid))
        self.expand = nn.Sequential(enn.Conv(mid, out_ch, 1, bias=False),
                                    enn.BatchNorm(out_ch))
        self.drop = enn.SpatialDropout(dropout)
        self.out_act = _act(relu, out_ch)

    def forward(self, x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        skip = P.max_unpool2d_2x2(self.skip_conv(x), indices)
        main = self.drop(self.expand(self.up(self.reduce(x))))
        return self.out_act(main + skip)


def _mix(relu: bool) -> nn.Sequential:
    return nn.Sequential(
        RegularBottleneck(128, relu=relu),
        RegularBottleneck(128, dilation=2, relu=relu),
        RegularBottleneck(128, asymmetric=True, relu=relu),
        RegularBottleneck(128, dilation=4, relu=relu),
        RegularBottleneck(128, relu=relu),
        RegularBottleneck(128, dilation=8, relu=relu),
        RegularBottleneck(128, asymmetric=True, relu=relu),
        RegularBottleneck(128, dilation=16, relu=relu))


@register("enet")
class ENet(enn.SegModel):
    """Input ``(N, in_ch, H, W)`` with H and W multiples of 8; logits
    ``(N, classes, H, W)``."""

    LOGITS_TAIL = "conv"

    def __init__(self, classes: int = 19, in_ch: int = 3,
                 encoder_relu: bool = False, decoder_relu: bool = True):
        super().__init__()
        self.classes = classes
        self.initial = InitialBlock(in_ch, 16)
        self.down1 = DownsamplingBottleneck(16, 64, dropout=0.01,
                                            relu=encoder_relu)
        self.stage1 = nn.Sequential(*[
            RegularBottleneck(64, dropout=0.01, relu=encoder_relu)
            for _ in range(4)])
        self.down2 = DownsamplingBottleneck(64, 128, dropout=0.1,
                                            relu=encoder_relu)
        self.stage2 = _mix(encoder_relu)
        self.stage3 = _mix(encoder_relu)
        self.up4 = UpsamplingBottleneck(128, 64, relu=decoder_relu)
        self.stage4 = nn.Sequential(
            RegularBottleneck(64, relu=decoder_relu),
            RegularBottleneck(64, relu=decoder_relu))
        self.up5 = UpsamplingBottleneck(64, 16, relu=decoder_relu)
        self.stage5 = RegularBottleneck(16, relu=decoder_relu)
        self.fullconv = enn.ConvTranspose(16, classes, 3, stride=2, padding=1,
                                          output_padding=1, bias=False)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The 16-channel half-resolution features under ``fullconv``."""
        y = self.initial(x)
        y, idx1 = self.down1(y)
        y = self.stage1(y)
        y, idx2 = self.down2(y)
        y = self.stage3(self.stage2(y))
        y = self.stage4(self.up4(y, idx2))
        return self.stage5(self.up5(y, idx1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fullconv(self.features(x))
