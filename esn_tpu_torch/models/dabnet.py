"""DABNet (Li & Kim 2019, arXiv 1907.11357); counterpart of
``esn_tpu/models/dabnet.py``.

DAB module: BN PReLU -> 3x3 reduce to ch/2 -> two depthwise asymmetric
branches, (3,1)+(1,3) plain and dilated, each then BN PReLU -> sum -> 1x1
expand -> residual. Stages: 3 modules d=2 at 1/4; 6 modules d=4,4,8,8,16,16
at 1/8; raw-input injections at 1/2, 1/4 and 1/8; a 1x1 head without bias
at 1/8. ``predict`` fuses the x8 upsample + argmax and the CE-family
losses train through ``logits_lowres``.

The reference's virtual-concat inputs (lists of pieces that BN, PReLU and
the convs split their parameters over) are ``torch.cat`` then the
ordinary module here: exact in f32; in bf16 the reference rounds once per
piece. Its scanned module chains are ``Sequential`` (the same variable
paths) and its lane-folded path is not ported.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import nn as enn
from ..ops import pooling as P
from ..ops import resize as R
from .blocks import BNAct, ConvBNAct, InputInjection
from .registry import register

BN_EPS = 1e-3


class DABModule(nn.Module):
    def __init__(self, ch: int, dilation: int = 2):
        super().__init__()
        half, d = ch // 2, dilation
        self.pre = BNAct(ch, act="prelu", bn_eps=BN_EPS)
        self.reduce = ConvBNAct(ch, half, 3, act="prelu", bn_eps=BN_EPS)
        self.a1 = enn.Conv(half, half, (3, 1), padding=(1, 0), groups=half,
                           bias=False)
        self.a2 = enn.Conv(half, half, (1, 3), padding=(0, 1), groups=half,
                           bias=False)
        self.a_post = BNAct(half, act="prelu", bn_eps=BN_EPS)
        self.b1 = enn.Conv(half, half, (3, 1), padding=(d, 0),
                           dilation=(d, 1), groups=half, bias=False)
        self.b2 = enn.Conv(half, half, (1, 3), padding=(0, d),
                           dilation=(1, d), groups=half, bias=False)
        self.b_post = BNAct(half, act="prelu", bn_eps=BN_EPS)
        self.expand = enn.Conv(half, ch, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.reduce(self.pre(x))
        a = self.a_post(self.a2(self.a1(y)))
        b = self.b_post(self.b2(self.b1(y)))
        return x + self.expand(a + b)


class DownSamplingBlock(nn.Module):
    """3x3 s2 conv (bias) of width out-in || 2x2 max pool of the input ->
    concat -> BN PReLU; a plain strided conv when ``out_ch <= in_ch``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.concat_pool = out_ch > in_ch
        conv_out = out_ch - in_ch if self.concat_pool else out_ch
        self.conv = enn.Conv(in_ch, conv_out, 3, stride=2, padding=1,
                             bias=True)
        self.post = BNAct(out_ch, act="prelu", bn_eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.concat_pool:
            y = torch.cat([y, P.max_pool2d(x, 2, 2)], dim=1)
        return self.post(y)


@register("dabnet")
class DABNet(enn.SegModel):
    LOGITS_TAIL = "resize"

    def __init__(self, classes: int = 19, in_ch: int = 3):
        super().__init__()
        self.classes = classes
        self.stem = nn.Sequential(
            ConvBNAct(in_ch, 32, 3, stride=2, act="prelu", bn_eps=BN_EPS),
            ConvBNAct(32, 32, 3, act="prelu", bn_eps=BN_EPS),
            ConvBNAct(32, 32, 3, act="prelu", bn_eps=BN_EPS))
        self.inj1 = InputInjection(1)
        self.inj2 = InputInjection(2)
        self.inj3 = InputInjection(3)
        self.b1 = BNAct(32 + in_ch, act="prelu", bn_eps=BN_EPS)
        self.down1 = DownSamplingBlock(32 + in_ch, 64)
        self.block1 = nn.Sequential(*[DABModule(64, 2) for _ in range(3)])
        self.b2 = BNAct(128 + in_ch, act="prelu", bn_eps=BN_EPS)
        self.down2 = DownSamplingBlock(128 + in_ch, 128)
        self.block2 = nn.Sequential(*[
            nn.Sequential(DABModule(128, d), DABModule(128, d))
            for d in (4, 8, 16)])
        self.b3 = BNAct(256 + in_ch, act="prelu", bn_eps=BN_EPS)
        self.head = enn.Conv(256 + in_ch, classes, 1, bias=False)

    def logits_lowres(self, x: torch.Tensor) -> torch.Tensor:
        """1/8-res logits (``predict`` fuses the x8 upsample + argmax)."""
        p1 = self.b1(torch.cat([self.stem(x), self.inj1(x)], dim=1))
        d1 = self.down1(p1)                                      # 1/4, 64
        p2 = self.b2(torch.cat([self.block1(d1), d1, self.inj2(x)], dim=1))
        d2 = self.down2(p2)                                      # 1/8, 128
        p3 = self.b3(torch.cat([self.block2(d2), d2, self.inj3(x)], dim=1))
        return self.head(p3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.logits_lowres(x)
        return R.resize_bilinear(y.float(), tuple(x.shape[2:])).to(y.dtype)
