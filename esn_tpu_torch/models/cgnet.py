"""CGNet M3N21 (Wu et al. 2018, arXiv 1811.08201); counterpart of
``esn_tpu/models/cgnet.py``.

The context-guided block joins local (depthwise 3x3) and surrounding
(depthwise dilated 3x3) context of a 1x1-reduced input, then gates the
channels with a GAP -> FC -> sigmoid unit (FGlo). Stages: M=3 blocks at 1/4
(d=2), N=21 at 1/8 (d=4), with raw-input injections at each downsampling.

The reference's TPU layout work has no counterpart: its lane-folded stem
is the plain ``stem``, its virtual-concat injections are ``torch.cat`` then
the ordinary module (exact in f32; in bf16 the reference rounds once per
piece), its scanned block chains are ``Sequential`` (the same variable
paths), and its lane-folded depthwise path is not ported.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import nn as enn
from ..ops import kernels as K
from ..ops import resize as R
from .blocks import BNAct, ConvBNAct, InputInjection, SEGate
from .registry import register

BN_EPS = 1e-3


class FGlo(SEGate):
    """Global context channel gate (GAP -> FC/r -> ReLU -> FC -> sigmoid)."""


class CGBlock(nn.Module):
    """Residual context-guided block at constant resolution.

    In eval mode the block up to the gate is one call of the
    ``fused_cgblock_pre`` kernel with both BNs folded into affines (the
    plain ``cgblock_pre_ref`` for a CPU tensor); the gate and the residual
    follow from its spatial sums. Training runs the composed path.
    """

    def __init__(self, ch: int, dilation: int = 2, reduction: int = 16):
        super().__init__()
        half = ch // 2
        self.ch, self.dilation = ch, dilation
        self.reduce = ConvBNAct(ch, half, 1, act="prelu", bn_eps=BN_EPS)
        self.loc = enn.Conv(half, half, 3, padding=1, groups=half, bias=False)
        self.sur = enn.Conv(half, half, 3, padding=dilation, dilation=dilation,
                            groups=half, bias=False)
        self.join = BNAct(ch, bn_eps=BN_EPS)
        self.glo = FGlo(ch, reduction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self.forward_composed(x)
        return self.forward_fused(x)

    def forward_composed(self, x: torch.Tensor) -> torch.Tensor:
        y = self.reduce(x)
        y = self.join(torch.cat([self.loc(y), self.sur(y)], dim=1))
        return x + self.glo(y)

    def forward_fused(self, x: torch.Tensor) -> torch.Tensor:
        half = self.ch // 2
        a1, b1 = self.reduce.bn.eval_affine()
        a2, b2 = self.join.bn.eval_affine()
        taps = lambda conv: conv.weight.reshape(half, 3, 3).permute(1, 2, 0)  # noqa: E731
        j, sums = K.fused_cgblock_pre(
            x.permute(0, 2, 3, 1).contiguous(),
            self.reduce.conv.weight.reshape(half, -1).t(),
            a1, b1, self.reduce.act.weight, taps(self.loc), taps(self.sur),
            a2, b2, self.join.act.weight, d=self.dilation)
        mean = (sums / (x.shape[2] * x.shape[3])).to(x.dtype)
        g = self.glo.gate(mean)
        return x + j.permute(0, 3, 1, 2) * g[:, :, None, None]


class CGBlockDown(nn.Module):
    """Strided context-guided block (no residual): full 3x3/s2, dual
    depthwise context, 1x1 re-fuse, FGlo."""

    def __init__(self, in_ch: int, out_ch: int, dilation: int = 2,
                 reduction: int = 16):
        super().__init__()
        self.conv = ConvBNAct(in_ch, out_ch, 3, stride=2, act="prelu",
                              bn_eps=BN_EPS)
        self.loc = enn.Conv(out_ch, out_ch, 3, padding=1, groups=out_ch,
                            bias=False)
        self.sur = enn.Conv(out_ch, out_ch, 3, padding=dilation,
                            dilation=dilation, groups=out_ch, bias=False)
        self.join_bn = BNAct(2 * out_ch, bn_eps=BN_EPS)
        self.refuse = enn.Conv(2 * out_ch, out_ch, 1, bias=False)
        self.glo = FGlo(out_ch, reduction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        y = self.join_bn(torch.cat([self.loc(y), self.sur(y)], dim=1))
        return self.glo(self.refuse(y))


@register("cgnet", "context_guided_network")
class CGNet(enn.SegModel):
    LOGITS_TAIL = "resize"

    def __init__(self, classes: int = 19, in_ch: int = 3, m: int = 3,
                 n: int = 21, dropout: float = 0.0):
        super().__init__()
        self.classes = classes
        self.stem = nn.Sequential(
            ConvBNAct(in_ch, 32, 3, stride=2, act="prelu", bn_eps=BN_EPS),
            ConvBNAct(32, 32, 3, act="prelu", bn_eps=BN_EPS),
            ConvBNAct(32, 32, 3, act="prelu", bn_eps=BN_EPS))
        self.inj1 = InputInjection(1)
        self.inj2 = InputInjection(2)
        self.b1 = BNAct(32 + in_ch, bn_eps=BN_EPS)
        self.down2 = CGBlockDown(32 + in_ch, 64, dilation=2, reduction=8)
        self.stage2 = nn.Sequential(*[CGBlock(64, 2, 8) for _ in range(m - 1)])
        self.b2 = BNAct(128 + in_ch, bn_eps=BN_EPS)
        self.down3 = CGBlockDown(128 + in_ch, 128, dilation=4, reduction=16)
        self.stage3 = nn.Sequential(*[CGBlock(128, 4, 16)
                                      for _ in range(n - 1)])
        self.b3 = BNAct(256, bn_eps=BN_EPS)
        self.drop = enn.SpatialDropout(dropout)
        self.head = enn.Conv(256, classes, 1, bias=False)

    def logits_lowres(self, x: torch.Tensor) -> torch.Tensor:
        """1/8-res logits (``predict`` fuses the x8 upsample + argmax)."""
        s1 = self.stem(x)                                        # 1/2, 32
        i1, i2 = self.inj1(x), self.inj2(x)
        p1 = self.b1(torch.cat([s1, i1], dim=1))
        d2 = self.down2(p1)                                      # 1/4, 64
        s2 = self.stage2(d2)
        p2 = self.b2(torch.cat([s2, d2, i2], dim=1))
        d3 = self.down3(p2)                                      # 1/8, 128
        s3 = self.stage3(d3)
        y = self.b3(torch.cat([s3, d3], dim=1))
        return self.head(self.drop(y))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.logits_lowres(x)
        return R.resize_bilinear(y.float(), tuple(x.shape[2:])).to(y.dtype)
