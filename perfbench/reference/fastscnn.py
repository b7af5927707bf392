"""Fast-SCNN (Poudel et al. 2019, arXiv:1902.04502), plain PyTorch, f32.

As the paper's Table 1 and its reference repository's
``model/FastSCNN.py`` lay it out:

- learning to downsample: conv 3->32 s2, DSConv 32->48 s2, DSConv 48->64 s2
- global feature extractor at 1/8: inverted residuals (expansion 6, ReLU6)
  64 x3 s2, 96 x3 s2, 128 x3 s1, then a pyramid pooling module (bins 1,
  2, 3, 6; 1x1 reduce to 32 each, bilinear upsample, concat, 1x1 fuse)
- feature fusion: the 1/32 path upsampled x4, depthwise 3x3 and 1x1
  (linear), the 1/8 path 1x1 (linear), added, ReLU
- classifier: two DSConv 128, dropout 0.1, 1x1 conv (bias) to the
  classes; the logits upsampled x8.

DSConv is depthwise 3x3 -> BN -> ReLU -> 1x1 -> BN -> ReLU. Departures
from the paper, shared with the program: the depthwise convs of the
fusion carry a BN and no activation, and BN's epsilon is 1e-5.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import (AdaptivePool, Conv, ConvBNAct, Dropout,
                     ReferenceModel, Resize, Stage)


class DSConv(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.cin, self.cout, self.stride = cin, cout, stride
        self.dw = ConvBNAct(cin, cin, 3, stride=stride, groups=cin)
        self.pw = ConvBNAct(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(self.dw(x))


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1,
                 expansion: int = 6):
        super().__init__()
        mid = cin * expansion
        self.use_res = stride == 1 and cin == cout
        self.expand = ConvBNAct(cin, mid, 1, act="relu6")
        self.dw = ConvBNAct(mid, mid, 3, stride=stride, groups=mid,
                            act="relu6")
        self.project = ConvBNAct(mid, cout, 1, act="none")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.project(self.dw(self.expand(x)))
        return x + y if self.use_res else y


class LearningToDownsample(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = ConvBNAct(3, 32, 3, stride=2)
        self.ds1 = DSConv(32, 48, 2)
        self.ds2 = DSConv(48, 64, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ds2(self.ds1(self.conv(x)))


class PyramidPooling(nn.Module):
    BINS = (1, 2, 3, 6)

    def __init__(self, cin: int = 128, cout: int = 128):
        super().__init__()
        red = cin // len(self.BINS)
        for i, b in enumerate(self.BINS):
            setattr(self, f"pool{i}", AdaptivePool(b))
            setattr(self, f"reduce{i}", ConvBNAct(cin, red, 1))
        self.up = Resize()
        self.fuse = ConvBNAct(cin + red * len(self.BINS), cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for i in range(len(self.BINS)):
            y = getattr(self, f"reduce{i}")(getattr(self, f"pool{i}")(x))
            feats.append(self.up(y, x.shape[2:]))
        return self.fuse(torch.cat(feats, dim=1))


def _stage(cin: int, cout: int, n: int, stride: int) -> Stage:
    return Stage(InvertedResidual(cin, cout, stride),
                 *[InvertedResidual(cout, cout) for _ in range(n - 1)])


class GlobalFeatureExtractor(nn.Module):
    def __init__(self):
        super().__init__()
        self.s1 = _stage(64, 64, 3, 2)
        self.s2 = _stage(64, 96, 3, 2)
        self.s3 = _stage(96, 128, 3, 1)
        self.ppm = PyramidPooling()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ppm(self.s3(self.s2(self.s1(x))))


class FeatureFusion(nn.Module):
    def __init__(self):
        super().__init__()
        self.up = Resize()
        self.low_dw = ConvBNAct(128, 128, 3, groups=128, act="none")
        self.low_pw = ConvBNAct(128, 128, 1, act="none")
        self.high_pw = ConvBNAct(64, 128, 1, act="none")

    def forward(self, high: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
        low = self.low_pw(self.low_dw(self.up(low, high.shape[2:])))
        return torch.relu(self.high_pw(high) + low)


class Classifier(nn.Module):
    def __init__(self, ch: int, classes: int):
        super().__init__()
        self.ds1 = DSConv(ch, ch)
        self.ds2 = DSConv(ch, ch)
        self.drop = Dropout(0.1)
        self.conv = Conv(ch, classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.drop(self.ds2(self.ds1(x))))


class FastSCNN(ReferenceModel):
    def __init__(self, classes: int = 19):
        super().__init__()
        self.ltd = LearningToDownsample()
        self.gfe = GlobalFeatureExtractor()
        self.ffm = FeatureFusion()
        self.head = Classifier(128, classes)
        self.tail = Resize()

    def logits_lowres(self, x: torch.Tensor) -> torch.Tensor:
        high = self.ltd(x)
        return self.head(self.ffm(high, self.gfe(high)))


def build(classes: int) -> FastSCNN:
    return FastSCNN(classes)
