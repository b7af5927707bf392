"""SegNet (Badrinarayanan et al. 2015, arXiv 1511.00561); counterpart of
``esn_tpu/models/segnet.py``.

VGG16's 13-conv encoder with five 2x2 index-saving max pools, and the
mirrored decoder driven by the max-unpool of those indices
(``ops.pooling``). Without an output size the unpool doubles each side,
as the reference's does, so H and W must be multiples of 32 (CamVid's
360x480 runs at 352x480).
"""
from __future__ import annotations

import torch

from .. import nn as enn
from ..ops import pooling as P
from .blocks import ConvBNAct
from .registry import register

VGG_CFG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


@register("segnet")
class SegNet(enn.SegModel):
    LOGITS_TAIL = "conv"

    def __init__(self, classes: int = 19, in_ch: int = 3):
        super().__init__()
        self.classes = classes
        cin = in_ch
        for i, (ch, n) in enumerate(VGG_CFG):
            setattr(self, f"enc{i}", torch.nn.Sequential(*[
                ConvBNAct(cin if k == 0 else ch, ch, 3, act="relu")
                for k in range(n)]))
            cin = ch
        chs = [c for c, _ in VGG_CFG]
        for j, stage in enumerate(range(4, -1, -1)):
            ch, n = chs[stage], VGG_CFG[stage][1]
            out = chs[stage - 1] if stage > 0 else ch
            convs = [ConvBNAct(ch, ch, 3, act="relu") for _ in range(n - 1)]
            convs.append(ConvBNAct(ch, out, 3, act="relu"))
            setattr(self, f"dec{j}", torch.nn.Sequential(*convs))
        self.head = enn.Conv(chs[0], classes, 3, padding=1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        indices = []
        for i in range(len(VGG_CFG)):
            x, idx = P.max_pool2d_with_indices_2x2(getattr(self, f"enc{i}")(x))
            indices.append(idx)
        for j in range(len(VGG_CFG)):
            x = getattr(self, f"dec{j}")(P.max_unpool2d_2x2(x, indices[4 - j]))
        return self.head(x)
