"""FPENet (Liu & Yin 2019, arXiv 1909.08599); counterpart of
``esn_tpu/models/fpenet.py``.

FPE block: 1x1 expand (t times the output width) -> ``scales`` channel
groups -> a depthwise 3x3 per group at dilations 1, 2, 4, 8, each group's
output added into the next group's input (an in-block feature pyramid)
-> concat -> 1x1 project -> SE gate -> residual -> relu. Encoder at 1/2,
1/4 and 1/8; decoder: two MEU (mutual embedding upsample) stages back to
1/2, a 1x1 head, then an f32 bilinear x2 upsample. ``LOGITS_TAIL`` is
``"resize"`` but the model has no ``logits_lowres`` (its head sits at
1/2, above a decoder), so the CE-family losses run on the full logits.
``predict`` is the reference's fused x2 head
(``ops.classify.resize2x_head_argmax``: the head at 1/2, then the
``resize_argmax`` kernel at r = 2), which never builds the
full-resolution logits; an odd input side takes the argmax of the full
logits, as in the reference.

The reference's lane-folded and group-major FPE paths and the W-folded
layout of its x2 head are TPU layout work and are not ported; its
scanned stages are ``nn.Sequential`` (the same variable paths).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .. import nn as enn
from ..nn.layers import _at_least_f32
from ..ops import classify as CL
from ..ops import pooling as P
from ..ops import resize as R
from .blocks import ConvBNAct, SEGate
from .registry import register


class FPEBlock(nn.Module):
    """Feature pyramid encoding block; the depthwise convs are
    ``dw0..dw{scales-1}``."""

    def __init__(self, in_ch: int, out_ch: int, *, stride: int = 1,
                 t: int = 4, scales: int = 4,
                 dilations: Sequence[int] = (1, 2, 4, 8),
                 reduction: int = 16):
        super().__init__()
        mid = out_ch * t
        if mid % scales:
            raise ValueError(f"{mid} channels do not split into {scales}")
        self.scales, self.g = scales, mid // scales
        self.expand = ConvBNAct(in_ch, mid, 1, stride=stride, act="relu")
        for i, d in enumerate(dilations[:scales]):
            setattr(self, f"dw{i}", ConvBNAct(self.g, self.g, 3, dilation=d,
                                              groups=self.g, act="relu"))
        self.project = ConvBNAct(mid, out_ch, 1, act="none")
        self.se = SEGate(out_ch, reduction)
        self.use_res = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.expand(x)
        outs, prev = [], None
        for i in range(self.scales):
            group = y[:, i * self.g:(i + 1) * self.g]
            prev = getattr(self, f"dw{i}")(group if prev is None
                                           else group + prev)
            outs.append(prev)
        y = self.se(self.project(torch.cat(outs, dim=1)))
        return enn.relu(x + y if self.use_res else y)


class MEU(nn.Module):
    """Mutual embedding upsample: the deep features, upsampled to the
    shallow ones' size, gated by the shallow spatial attention (the
    channel mean, taken in f32, -> 1x1 -> sigmoid); the shallow features
    gated by the deep channel attention (GAP -> 1x1 -> sigmoid); summed,
    relu."""

    def __init__(self, deep_ch: int, shallow_ch: int, out_ch: int):
        super().__init__()
        self.deep_conv = ConvBNAct(deep_ch, out_ch, 1, act="none")
        self.shallow_conv = ConvBNAct(shallow_ch, out_ch, 1, act="none")
        self.chan_fc = enn.Conv(out_ch, out_ch, 1, bias=True)
        self.spat_conv = enn.Conv(1, 1, 1, bias=True)

    def forward(self, deep: torch.Tensor,
                shallow: torch.Tensor) -> torch.Tensor:
        d = self.deep_conv(deep)
        s = self.shallow_conv(shallow)
        ca = torch.sigmoid(self.chan_fc(P.global_avg_pool(d)))
        sa = s.to(_at_least_f32(s.dtype)).mean(dim=1, keepdim=True)
        sa = torch.sigmoid(self.spat_conv(sa.to(s.dtype)))
        d_up = R.resize_bilinear(d, tuple(s.shape[2:]))
        return enn.relu(d_up * sa + s * ca)


@register("fpenet")
class FPENet(enn.SegModel):
    LOGITS_TAIL = "resize"

    def __init__(self, classes: int = 19, in_ch: int = 3, width: int = 16):
        super().__init__()
        self.classes = classes
        w = width
        self.stem = ConvBNAct(in_ch, w, 3, stride=2, act="relu")     # 1/2
        self.stage1 = FPEBlock(w, w, t=1)
        self.down2 = FPEBlock(w, 2 * w, stride=2, t=4)               # 1/4
        self.stage2 = nn.Sequential(*[FPEBlock(2 * w, 2 * w, t=4)
                                      for _ in range(2)])
        self.down3 = FPEBlock(2 * w, 4 * w, stride=2, t=4)           # 1/8
        self.stage3 = nn.Sequential(*[FPEBlock(4 * w, 4 * w, t=4)
                                      for _ in range(8)])
        self.meu2 = MEU(4 * w, 2 * w, 2 * w)
        self.meu1 = MEU(2 * w, w, w)
        self.head = enn.Conv(w, classes, 1, bias=True)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The decoder's output at 1/2 resolution (the head's input)."""
        s1 = self.stage1(self.stem(x))
        s2 = self.stage2(self.down2(s1))
        s3 = self.stage3(self.down3(s2))
        return self.meu1(self.meu2(s3, s2), s1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.head(self.features(x))
        return R.resize_bilinear(y.float(), tuple(x.shape[2:])).to(y.dtype)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """The fused x2 head (``ops.classify.resize2x_head_argmax``) where
        H and W are even, else the argmax of the full logits."""
        if x.shape[2] % 2 or x.shape[3] % 2:
            return super().predict(x)
        return CL.resize2x_head_argmax(self.features(x).permute(0, 2, 3, 1),
                                       self.head)
