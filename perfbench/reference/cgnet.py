"""CGNet M=3 N=21 (Wu et al. 2018, arXiv:1811.08201), plain PyTorch, f32.

As the paper's Table 1 and its reference repository's ``model/CGNet.py``
lay it out:

- stage 1 at 1/2: three 3x3 convs 3->32 (the first stride 2), each
  BN + PReLU; the raw input, average-pooled (3x3 s2, padding 1, padded
  zeros counted) once and twice, is injected at 1/2 and 1/4
- stage 2 at 1/4: a down-sampling CG block (3x3 s2 conv, BN + PReLU,
  the local depthwise 3x3 and the surrounding depthwise 3x3 at dilation
  2, concat, BN + PReLU, 1x1 re-fuse, global context gate), then M-1 = 2
  residual CG blocks (1x1 reduce to half, BN + PReLU, local and
  surrounding context at dilation 2, concat, BN + PReLU, gate, add)
- stage 3 at 1/8: a down-sampling block at dilation 4, then N-1 = 20
  residual blocks at dilation 4
- BN + PReLU over the concat of stage 3's output and its first block's,
  a 1x1 conv to the classes (no bias), the logits upsampled x8.

The global context gate (FGlo) is GAP -> FC (C/r) -> ReLU -> FC (C) ->
sigmoid -> scale, with r = 8 at stage 2 and 16 at stage 3. BN's epsilon
is 1e-3. The classifier's channel dropout has rate 0, as in the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (BNAct, Conv, ConvBNAct, Dense, Dropout, ReferenceModel,
                     Resize, Stage)

EPS = 1e-3


class FGlo(nn.Module):
    def __init__(self, ch: int, reduction: int):
        super().__init__()
        self.fc1 = Dense(ch, max(ch // reduction, 1))
        self.fc2 = Dense(max(ch // reduction, 1), ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = torch.sigmoid(self.fc2(torch.relu(self.fc1(x.mean(dim=(2, 3))))))
        return x * g[:, :, None, None]


class CGBlock(nn.Module):
    def __init__(self, ch: int, dilation: int, reduction: int):
        super().__init__()
        half = ch // 2
        self.ch, self.dilation = ch, dilation
        self.reduce = ConvBNAct(ch, half, 1, act="prelu", eps=EPS)
        self.loc = Conv(half, half, 3, padding=1, groups=half, bias=False)
        self.sur = Conv(half, half, 3, padding=dilation, dilation=dilation,
                        groups=half, bias=False)
        self.join = BNAct(ch, eps=EPS)
        self.glo = FGlo(ch, reduction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.reduce(x)
        y = self.join(torch.cat([self.loc(y), self.sur(y)], dim=1))
        return x + self.glo(y)


class CGBlockDown(nn.Module):
    def __init__(self, cin: int, cout: int, dilation: int, reduction: int):
        super().__init__()
        self.conv = ConvBNAct(cin, cout, 3, stride=2, act="prelu", eps=EPS)
        self.loc = Conv(cout, cout, 3, padding=1, groups=cout, bias=False)
        self.sur = Conv(cout, cout, 3, padding=dilation, dilation=dilation,
                        groups=cout, bias=False)
        self.join_bn = BNAct(2 * cout, eps=EPS)
        self.refuse = Conv(2 * cout, cout, 1, bias=False)
        self.glo = FGlo(cout, reduction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        y = self.join_bn(torch.cat([self.loc(y), self.sur(y)], dim=1))
        return self.glo(self.refuse(y))


def _inject(x: torch.Tensor, times: int) -> torch.Tensor:
    for _ in range(times):
        x = F.avg_pool2d(x, 3, 2, 1)
    return x


class CGNet(ReferenceModel):
    def __init__(self, classes: int = 19, m: int = 3, n: int = 21):
        super().__init__()
        self.stem = nn.Sequential(
            ConvBNAct(3, 32, 3, stride=2, act="prelu", eps=EPS),
            ConvBNAct(32, 32, 3, act="prelu", eps=EPS),
            ConvBNAct(32, 32, 3, act="prelu", eps=EPS))
        self.b1 = BNAct(35, eps=EPS)
        self.down2 = CGBlockDown(35, 64, 2, 8)
        self.stage2 = Stage(*[CGBlock(64, 2, 8) for _ in range(m - 1)])
        self.b2 = BNAct(131, eps=EPS)
        self.down3 = CGBlockDown(131, 128, 4, 16)
        self.stage3 = Stage(*[CGBlock(128, 4, 16) for _ in range(n - 1)])
        self.b3 = BNAct(256, eps=EPS)
        self.drop = Dropout(0.0, channel=True)
        self.head = Conv(256, classes, 1, bias=False)
        self.tail = Resize()

    def logits_lowres(self, x: torch.Tensor) -> torch.Tensor:
        s1 = self.stem(x)
        p1 = self.b1(torch.cat([s1, _inject(x, 1)], dim=1))
        d2 = self.down2(p1)
        s2 = self.stage2(d2)
        p2 = self.b2(torch.cat([s2, d2, _inject(x, 2)], dim=1))
        d3 = self.down3(p2)
        y = self.b3(torch.cat([self.stage3(d3), d3], dim=1))
        return self.head(self.drop(y))


def build(classes: int) -> CGNet:
    return CGNet(classes)
