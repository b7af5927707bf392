"""Fast-SCNN (Poudel et al. 2019, arXiv 1902.04502); counterpart of
``esn_tpu/models/fastscnn.py``.

- learning-to-downsample: conv 3->32 s2, dsconv 32->48 s2, dsconv 48->64 s2
- global feature extractor (1/8 in): inverted residuals t=6
  [64x3 s2, 96x3 s2, 128x3 s1] + PPM(128, bins 1,2,3,6)
- feature fusion: 1/32 path x4 upsample -> dwconv -> 1x1 (linear);
  1/8 path 1x1 (linear); add -> ReLU
- classifier: 2x dsconv 128 + dropout + 1x1 -> classes; x8 bilinear
"""
from __future__ import annotations

import torch
from torch import nn

from .. import nn as enn
from ..ops import resize as R
from .blocks import ConvBNAct, DSConv, InvertedResidual, PyramidPooling
from .registry import register


class LearningToDownsample(nn.Module):
    def __init__(self, in_ch=3, chs=(32, 48, 64)):
        super().__init__()
        c1, c2, c3 = chs
        self.conv = ConvBNAct(in_ch, c1, 3, stride=2, act="relu")
        self.ds1 = DSConv(c1, c2, stride=2)
        self.ds2 = DSConv(c2, c3, stride=2)

    def forward(self, x):
        return self.ds2(self.ds1(self.conv(x)))


class GlobalFeatureExtractor(nn.Module):
    def __init__(self, in_ch=64, chs=(64, 96, 128), expansion=6,
                 repeats=(3, 3, 3), out_ch=128):
        super().__init__()

        def stage(cin, cout, n, stride):
            mods = [InvertedResidual(cin, cout, expansion=expansion,
                                     stride=stride)]
            mods += [InvertedResidual(cout, cout, expansion=expansion)
                     for _ in range(n - 1)]
            return nn.Sequential(*mods)
        self.s1 = stage(in_ch, chs[0], repeats[0], 2)
        self.s2 = stage(chs[0], chs[1], repeats[1], 2)
        self.s3 = stage(chs[1], chs[2], repeats[2], 1)
        self.ppm = PyramidPooling(chs[2], out_ch)

    def forward(self, x):
        return self.ppm(self.s3(self.s2(self.s1(x))))


class FeatureFusion(nn.Module):
    """Add-fusion of the 1/8 spatial path and upsampled 1/32 context path."""

    def __init__(self, high_ch=64, low_ch=128, out_ch=128):
        super().__init__()
        self.low_dw = ConvBNAct(low_ch, low_ch, 3, groups=low_ch, act="none")
        self.low_pw = ConvBNAct(low_ch, out_ch, 1, act="none")
        self.high_pw = ConvBNAct(high_ch, out_ch, 1, act="none")

    def forward(self, high, low):
        low = R.resize_bilinear(low, tuple(high.shape[2:]))
        low = self.low_pw(self.low_dw(low))
        return enn.relu(self.high_pw(high) + low)


class Classifier(nn.Module):
    def __init__(self, ch, classes, dropout=0.1):
        super().__init__()
        self.ds1 = DSConv(ch, ch)
        self.ds2 = DSConv(ch, ch)
        self.drop = enn.Dropout(dropout)
        self.conv = enn.Conv(ch, classes, 1, bias=True)

    def forward(self, x):
        return self.conv(self.drop(self.ds2(self.ds1(x))))


@register("fastscnn", "fast_scnn", "fast-scnn")
class FastSCNN(enn.SegModel):
    LOGITS_TAIL = "resize"

    def __init__(self, classes: int = 19, in_ch: int = 3):
        super().__init__()
        self.classes = classes
        self.ltd = LearningToDownsample(in_ch)
        self.gfe = GlobalFeatureExtractor()
        self.ffm = FeatureFusion()
        self.head = Classifier(128, classes)

    def logits_lowres(self, x: torch.Tensor) -> torch.Tensor:
        """1/8-res logits (``predict`` fuses the x8 upsample + argmax)."""
        high = self.ltd(x)          # 1/8
        low = self.gfe(high)        # 1/32
        return self.head(self.ffm(high, low))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.logits_lowres(x)
        return R.resize_bilinear(y.float(), tuple(x.shape[2:])).to(y.dtype)
