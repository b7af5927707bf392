"""ESPNetv2 segmentation (Mehta et al. 2019, arXiv 1811.11431); counterpart
of ``esn_tpu/models/espnetv2.py``.

EESP unit: grouped 1x1 reduce -> k depthwise dilated 3x3 branches (d = 1,
2, 4, 8) -> hierarchical feature fusion (prefix sums of the branches) ->
concat -> BN PReLU -> grouped 1x1 expand -> residual -> PReLU. A strided
EESP concatenates an average-pooled copy of its input and adds a
projection of the raw image, resized to its output. Head: pyramid pooling
at 1/16, upsampled to 1/8 and fused with a projection of the 1/8 level by
an EESP, classes at 1/8; ``predict`` fuses the x8 upsample + argmax and
the CE-family losses train through ``logits_lowres``.

The reference's grouped 1x1 convs run as block-diagonal dense kernels on
its device; here they are the native ``groups`` of ``Conv`` (the stored
kernel is the grouped one in both). Its lane-folded branch path is not
ported, and its scanned EESP chains are ``Sequential`` (the same variable
paths).
"""
from __future__ import annotations

import torch
from torch import nn

from .. import nn as enn
from ..ops import pooling as P
from ..ops import resize as R
from .blocks import BNAct, ConvBNAct, PyramidPooling
from .registry import register

BN_EPS = 1e-3


class EESP(nn.Module):
    """Extremely efficient spatial pyramid unit; the reduced input is
    average-pooled 3x3/s2 before the branches when ``stride`` is 2."""

    def __init__(self, in_ch: int, out_ch: int, *, stride: int = 1,
                 k: int = 4, groups: int = 4, residual: bool = True):
        super().__init__()
        d = max(out_ch // k, 1)
        rem = out_ch - d * (k - 1)
        self.k, self.stride = k, stride
        g = groups if (in_ch % groups == 0 and d % groups == 0) else 1
        self.reduce = ConvBNAct(in_ch, d, 1, groups=g, act="prelu",
                                bn_eps=BN_EPS)
        for i in range(k):
            dil = 2 ** i
            out = rem if i == k - 1 else d
            setattr(self, f"d{i}", enn.Conv(
                d, out, 3, padding=dil, dilation=dil,
                groups=d if out % d == 0 else 1, bias=False))
        self.concat_bn = BNAct(out_ch, act="prelu", bn_eps=BN_EPS)
        ge = groups if out_ch % groups == 0 else 1
        self.expand = ConvBNAct(out_ch, out_ch, 1, groups=ge, act="none",
                                bn_eps=BN_EPS)
        self.residual = residual and stride == 1 and in_ch == out_ch
        self.act = enn.PReLU(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.reduce(x)
        if self.stride == 2:
            y = P.avg_pool2d(y, 3, 2, 1)
        outs = [getattr(self, f"d{i}")(y) for i in range(self.k)]
        fused, acc = [outs[0]], None
        for i in range(1, self.k):
            acc = outs[i] if i == 1 else acc + outs[i]
            fused.append(acc)
        y = self.expand(self.concat_bn(torch.cat(fused, dim=1)))
        if self.residual:
            y = y + x
        return self.act(y)


class StridedEESP(nn.Module):
    """Stride-2 EESP || 3x3/s2 average pool of the input, plus a 3x3 ->
    1x1 projection of the raw image resized (bilinear, no antialias) to
    the output's size, then PReLU."""

    def __init__(self, in_ch: int, out_ch: int, *, k: int = 4,
                 groups: int = 4, in_image_ch: int = 3):
        super().__init__()
        if out_ch <= in_ch:
            raise ValueError(f"StridedEESP widens: {in_ch} -> {out_ch}")
        self.eesp = EESP(in_ch, out_ch - in_ch, stride=2, k=k, groups=groups,
                         residual=False)
        self.img_conv = nn.Sequential(
            ConvBNAct(in_image_ch, in_image_ch, 3, act="prelu",
                      bn_eps=BN_EPS),
            ConvBNAct(in_image_ch, out_ch, 1, act="none", bn_eps=BN_EPS))
        self.act = enn.PReLU(out_ch)

    def forward(self, x: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
        y = torch.cat([self.eesp(x), P.avg_pool2d(x, 3, 2, 1)], dim=1)
        img = R.resize_bilinear(image, tuple(y.shape[2:]))
        return self.act(y + self.img_conv(img))


@register("espnetv2", "espnet_v2", "eespnet_seg")
class ESPNetV2Seg(enn.SegModel):
    LOGITS_TAIL = "resize"

    def __init__(self, classes: int = 19, in_ch: int = 3,
                 chs=(32, 128, 256, 512), repeats=(3, 7, 3)):
        super().__init__()
        self.classes = classes
        c0, c1, c2, c3 = chs
        self.stem = ConvBNAct(in_ch, c0, 3, stride=2, act="prelu",
                              bn_eps=BN_EPS)                       # 1/2
        self.down1 = StridedEESP(c0, c1)                           # 1/4
        self.level1 = nn.Sequential(*[EESP(c1, c1)
                                      for _ in range(repeats[0])])
        self.down2 = StridedEESP(c1, c2)                           # 1/8
        self.level2 = nn.Sequential(*[EESP(c2, c2)
                                      for _ in range(repeats[1])])
        self.down3 = StridedEESP(c2, c3)                           # 1/16
        self.level3 = nn.Sequential(*[EESP(c3, c3)
                                      for _ in range(repeats[2])])
        self.psp = PyramidPooling(c3, c2 // 2, act="relu")
        self.proj_l2 = ConvBNAct(c2, c2 // 2, 1, act="prelu", bn_eps=BN_EPS)
        self.fuse = EESP(c2, c2 // 2, residual=False)
        self.head = enn.Conv(c2 // 2, classes, 1, bias=False)

    def logits_lowres(self, x: torch.Tensor) -> torch.Tensor:
        """1/8-res logits (``predict`` fuses the x8 upsample + argmax)."""
        y = self.level1(self.down1(self.stem(x), x))
        l2 = self.level2(self.down2(y, x))                     # 1/8
        y = self.psp(self.level3(self.down3(l2, x)))           # 1/16
        y = R.resize_bilinear(y, tuple(l2.shape[2:]))          # 1/8
        return self.head(self.fuse(torch.cat([y, self.proj_l2(l2)], dim=1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.logits_lowres(x)
        return R.resize_bilinear(y.float(), tuple(x.shape[2:])).to(y.dtype)
