"""LEDNet (Wang et al. 2019, arXiv 1905.02423); counterpart of
``esn_tpu/models/lednet.py``.

Encoder: split-shuffle non-bottleneck units (channel split, one half
(3x1)(1x3) and the other (1x3)(3x1), each then a dilated factorized pair;
concat, spatial dropout, residual, channel shuffle) at 1/2, 1/4 and 1/8,
dilations 1, 2, 5, 9 and 17. Decoder: the attention pyramid (APN) at 1/8
emits class scores, then a x8 bilinear upsample. ``predict`` fuses that
upsample with the argmax and the CE-family losses train through
``logits_lowres``.

The reference's lane-folded SS-nbt path is TPU layout work and is not
ported; its scanned chains are ``nn.Sequential`` (the same variable paths).
"""
from __future__ import annotations

import torch
from torch import nn

from .. import nn as enn
from ..ops import pooling as P
from ..ops import resize as R
from .blocks import (BNAct, ConvBNAct, DownsamplerConcat, channel_shuffle,
                     channel_split)
from .registry import register

BN_EPS = 1e-3


class SSnbt(nn.Module):
    """Split-shuffle non-bottleneck unit on ``ch`` channels; biased convs,
    BN eps 1e-3."""

    def __init__(self, ch: int, dilation: int = 1, dropout: float = 0.0):
        super().__init__()
        half, d = ch // 2, dilation

        def conv(kernel, padding, dil=1):
            return enn.Conv(half, half, kernel, padding=padding,
                            dilation=dil, bias=True)
        self.l1 = conv((3, 1), (1, 0))
        self.l2 = conv((1, 3), (0, 1))
        self.l_bn1 = BNAct(half, act="relu", bn_eps=BN_EPS)
        self.l3 = conv((3, 1), (d, 0), (d, 1))
        self.l4 = conv((1, 3), (0, d), (1, d))
        self.l_bn2 = enn.BatchNorm(half, eps=BN_EPS)
        self.r1 = conv((1, 3), (0, 1))
        self.r2 = conv((3, 1), (1, 0))
        self.r_bn1 = BNAct(half, act="relu", bn_eps=BN_EPS)
        self.r3 = conv((1, 3), (0, d), (1, d))
        self.r4 = conv((3, 1), (d, 0), (d, 1))
        self.r_bn2 = enn.BatchNorm(half, eps=BN_EPS)
        self.drop = enn.SpatialDropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        left, right = channel_split(x)
        l = self.l_bn1(self.l2(enn.relu(self.l1(left))))
        l = self.l_bn2(self.l4(enn.relu(self.l3(l))))
        r = self.r_bn1(self.r2(enn.relu(self.r1(right))))
        r = self.r_bn2(self.r4(enn.relu(self.r3(r))))
        y = self.drop(torch.cat([l, r], dim=1))
        return channel_shuffle(enn.relu(x + y), 2)


class APN(nn.Module):
    """Attention pyramid at 1/8 resolution -> ``classes`` channels: a
    7/5/3 stride-2 cascade to 1/64, summed back up bilinearly with 5x5 and
    7x7 convs of the 1/32 and 1/16 levels; ``main(x) * pyramid`` plus
    ``glob`` of the global average pool."""

    def __init__(self, in_ch: int, classes: int):
        super().__init__()
        c = classes

        def cba(i, k, stride=1):
            return ConvBNAct(i, c, k, stride=stride, act="relu",
                             bn_eps=BN_EPS)
        self.down1 = cba(in_ch, 7, 2)         # 1/16
        self.down2 = cba(c, 5, 2)             # 1/32
        self.down3 = cba(c, 3, 2)             # 1/64
        self.lvl2 = cba(c, 5)
        self.lvl1 = cba(c, 7)
        self.main = cba(in_ch, 1)
        self.glob = ConvBNAct(in_ch, c, 1, act="none", bn=False, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d1 = self.down1(x)
        d2 = self.down2(d1)
        d3 = self.down3(d2)
        p = R.resize_bilinear(d3, tuple(d2.shape[2:])) + self.lvl2(d2)
        p = R.resize_bilinear(p, tuple(d1.shape[2:])) + self.lvl1(d1)
        p = R.resize_bilinear(p, tuple(x.shape[2:]))
        return self.main(x) * p + self.glob(P.global_avg_pool(x))


@register("lednet")
class LEDNet(enn.SegModel):
    LOGITS_TAIL = "resize"

    def __init__(self, classes: int = 19, in_ch: int = 3):
        super().__init__()
        self.classes = classes
        self.encoder = nn.Sequential(
            DownsamplerConcat(in_ch, 32, act="relu", bn_eps=BN_EPS),
            nn.Sequential(*[SSnbt(32, 1, 0.03) for _ in range(3)]),
            DownsamplerConcat(32, 64, act="relu", bn_eps=BN_EPS),
            nn.Sequential(*[SSnbt(64, 1, 0.03) for _ in range(2)]),
            DownsamplerConcat(64, 128, act="relu", bn_eps=BN_EPS),
            SSnbt(128, 1, 0.3),
            nn.Sequential(*[nn.Sequential(*[SSnbt(128, d, 0.3)
                                            for d in (2, 5, 9)])
                            for _ in range(2)]),
            SSnbt(128, 17, 0.3))
        self.apn = APN(128, classes)

    def logits_lowres(self, x: torch.Tensor) -> torch.Tensor:
        """1/8-res logits (``predict`` fuses the x8 upsample + argmax)."""
        return self.apn(self.encoder(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.logits_lowres(x)
        return R.resize_bilinear(y.float(), tuple(x.shape[2:])).to(y.dtype)
