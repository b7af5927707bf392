"""EDANet (Lo et al. 2018, arXiv 1809.06323); counterpart of
``esn_tpu/models/edanet.py``.

Dense asymmetric-dilated modules with growth rate 40: down(3->15),
down(15->60), 5 EDA modules d=(1,1,1,2,2) -> 260, down(260->130), 8 EDA
modules d=(2,2,4,4,8,8,16,16) -> 450, 1x1 -> classes, x8 bilinear.
``predict`` ends in the fused upsample + argmax and the CE-family losses
train through ``logits_lowres``.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import nn as enn
from ..ops import pooling as P
from ..ops import resize as R
from .registry import register


class DownsamplingBlock(nn.Module):
    """conv 3x3 s2 (bias) || 2x2 max pool -> concat -> BN (eps 1e-3) ->
    ReLU; a plain strided conv when ``out_ch <= in_ch``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.concat_pool = out_ch > in_ch
        conv_out = out_ch - in_ch if self.concat_pool else out_ch
        self.conv = enn.Conv(in_ch, conv_out, 3, stride=2, padding=1,
                             bias=True)
        self.bn = enn.BatchNorm(out_ch, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.concat_pool:
            y = torch.cat([y, P.max_pool2d(x, 2, 2)], dim=1)
        return enn.relu(self.bn(y))


class EDAModule(nn.Module):
    """1x1 reduce -> (3x1, 1x3) -> BN relu -> dilated (3x1, 1x3) -> BN
    relu -> spatial dropout -> concat with the input (growth k). Biased
    convs, BN eps 1e-3."""

    def __init__(self, in_ch: int, growth: int = 40, dilation: int = 1,
                 dropout: float = 0.02):
        super().__init__()
        k, d = growth, dilation
        self.reduce = enn.Conv(in_ch, k, 1, bias=True)
        self.a1 = enn.Conv(k, k, (3, 1), padding=(1, 0), bias=True)
        self.a2 = enn.Conv(k, k, (1, 3), padding=(0, 1), bias=True)
        self.bn1 = enn.BatchNorm(k, eps=1e-3)
        self.b1 = enn.Conv(k, k, (3, 1), padding=(d, 0), dilation=(d, 1),
                           bias=True)
        self.b2 = enn.Conv(k, k, (1, 3), padding=(0, d), dilation=(1, d),
                           bias=True)
        self.bn2 = enn.BatchNorm(k, eps=1e-3)
        self.drop = enn.SpatialDropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.a2(self.a1(self.reduce(x)))
        y = enn.relu(self.bn1(y))
        y = enn.relu(self.bn2(self.b2(self.b1(y))))
        return torch.cat([x, self.drop(y)], dim=1)


@register("edanet")
class EDANet(enn.SegModel):
    LOGITS_TAIL = "resize"

    def __init__(self, classes: int = 19, in_ch: int = 3, growth: int = 40):
        super().__init__()
        self.classes = classes
        self.down1 = DownsamplingBlock(in_ch, 15)
        self.down2 = DownsamplingBlock(15, 60)
        ch, block1 = 60, []
        for d in (1, 1, 1, 2, 2):
            block1.append(EDAModule(ch, growth, d))
            ch += growth
        self.block1 = nn.Sequential(*block1)          # 260
        self.down3 = DownsamplingBlock(ch, 130)
        ch, block2 = 130, []
        for d in (2, 2, 4, 4, 8, 8, 16, 16):
            block2.append(EDAModule(ch, growth, d))
            ch += growth
        self.block2 = nn.Sequential(*block2)          # 450
        self.head = enn.Conv(ch, classes, 1, bias=True)

    def logits_lowres(self, x: torch.Tensor) -> torch.Tensor:
        """1/8-res logits (``predict`` fuses the x8 upsample + argmax)."""
        y = self.block1(self.down2(self.down1(x)))
        return self.head(self.block2(self.down3(y)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.logits_lowres(x)
        return R.resize_bilinear(y.float(), tuple(x.shape[2:])).to(y.dtype)
