"""ContextNet (Poudel et al. 2018, arXiv 1805.04554); counterpart of
``esn_tpu/models/contextnet.py``.

Two branches fused additively at 1/8 resolution:

- shallow (full-resolution input): conv 3->32 s2, dsconv 32->64 s2,
  dsconv 64->128 s2, dsconv 128->128;
- deep (the input bilinearly downscaled x4, no antialias): conv 3->32 s2
  and a MobileNetV2 stack (t, c, n, s) = (1,32,1,1), (6,32,1,1),
  (6,48,3,2), (6,64,3,2), (6,96,2,1), (6,128,2,1), then a 1x1 conv: 1/32
  overall;
- fusion: the deep features upsampled to 1/8, a dilation-4 depthwise 3x3
  and a 1x1 (both linear), added to the shallow features' 1x1, ReLU;
- classifier: 2x dsconv 128, dropout 0.1, 1x1 -> classes; x8 bilinear.

In eval each of the five DSConvs is one call of the ``fused_dsconv``
kernel (``blocks.DSConv``); ``predict`` ends in the fused upsample +
argmax and the CE-family losses train through ``logits_lowres``. The
reference's W-folded stem is TPU layout work and has no counterpart.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import nn as enn
from ..ops import resize as R
from .blocks import ConvBNAct, DSConv, InvertedResidual
from .registry import register

# (expansion, out_ch, repeats, stride) of the deep branch's stages
DEEP_CFG = ((1, 32, 1, 1), (6, 32, 1, 1), (6, 48, 3, 2), (6, 64, 3, 2),
            (6, 96, 2, 1), (6, 128, 2, 1))


class ShallowNet(nn.Module):
    """Full-resolution spatial branch -> 1/8, 128 channels."""

    def __init__(self, in_ch: int = 3):
        super().__init__()
        self.conv = ConvBNAct(in_ch, 32, 3, stride=2, act="relu")
        self.ds1 = DSConv(32, 64, stride=2)
        self.ds2 = DSConv(64, 128, stride=2)
        self.ds3 = DSConv(128, 128, stride=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ds3(self.ds2(self.ds1(self.conv(x))))


class DeepNet(nn.Module):
    """Context branch on the x4-downscaled input -> 1/32, 128 channels."""

    def __init__(self, in_ch: int = 3):
        super().__init__()
        self.conv = ConvBNAct(in_ch, 32, 3, stride=2, act="relu")
        stages, cin = [], 32
        for t, c, n, s in DEEP_CFG:
            mods = [InvertedResidual(cin, c, expansion=t, stride=s)]
            mods += [InvertedResidual(c, c, expansion=t) for _ in range(n - 1)]
            stages.append(nn.Sequential(*mods))
            cin = c
        self.stages = nn.Sequential(*stages)
        self.tail = ConvBNAct(128, 128, 1, act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail(self.stages(self.conv(x)))


class FusionModule(nn.Module):
    def __init__(self, high_ch: int = 128, low_ch: int = 128,
                 out_ch: int = 128):
        super().__init__()
        self.low_dw = ConvBNAct(low_ch, low_ch, 3, groups=low_ch, dilation=4,
                                act="none")
        self.low_pw = ConvBNAct(low_ch, out_ch, 1, act="none")
        self.high_pw = ConvBNAct(high_ch, out_ch, 1, act="none")

    def forward(self, high: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
        low = R.resize_bilinear(low, tuple(high.shape[2:]))
        low = self.low_pw(self.low_dw(low))
        return enn.relu(self.high_pw(high) + low)


@register("contextnet", "context_net")
class ContextNet(enn.SegModel):
    LOGITS_TAIL = "resize"

    def __init__(self, classes: int = 19, in_ch: int = 3):
        super().__init__()
        self.classes = classes
        self.shallow = ShallowNet(in_ch)
        self.deep = DeepNet(in_ch)
        self.fusion = FusionModule()
        self.ds1 = DSConv(128, 128)
        self.ds2 = DSConv(128, 128)
        self.drop = enn.Dropout(0.1)
        self.head = enn.Conv(128, classes, 1, bias=True)

    def logits_lowres(self, x: torch.Tensor) -> torch.Tensor:
        """1/8-res logits (``predict`` fuses the x8 upsample + argmax)."""
        h, w = x.shape[2:]
        x_small = R.resize_bilinear(x, (h // 4, w // 4))
        y = self.fusion(self.shallow(x), self.deep(x_small))
        return self.head(self.drop(self.ds2(self.ds1(y))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.logits_lowres(x)
        return R.resize_bilinear(y.float(), tuple(x.shape[2:])).to(y.dtype)
