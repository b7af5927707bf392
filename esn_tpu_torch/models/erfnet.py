"""ERFNet (Romera et al. 2017); counterpart of ``esn_tpu/models/erfnet.py``.

Encoder: down(3->16), down(16->64), 5x nb1d(64, dropout .03);
down(64->128), 2x [nb1d d=2, 4, 8, 16] (dropout .3). Decoder: up(128->64),
2x nb1d; up(64->16), 2x nb1d; 2x2 stride-2 transposed conv -> classes.

The reference runs the repeated blocks as ``lax.scan`` bodies
(``nn.ScanChain``), whose variables lay out as a ``Sequential``'s
(children "0".."n-1"): here they are plain ``nn.Sequential``s. Its
lane-folded and space-to-depth paths are TPU layout work and have no
counterpart. ``predict`` is the reference's fused subpixel head on
``head`` (``blocks.subpixel_predict_tail``: K7 on the card), which never
builds the full-resolution logits.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import nn as enn
from .blocks import (DownsamplerConcat, NonBottleneck1d, UpsamplerBlock,
                     subpixel_predict_tail)
from .registry import register


@register("erfnet")
class ERFNet(enn.SegModel):
    LOGITS_TAIL = "conv"

    def __init__(self, classes: int = 19, in_ch: int = 3,
                 dropout_1: float = 0.03, dropout_2: float = 0.3):
        super().__init__()
        self.classes = classes
        self.encoder = nn.Sequential(
            DownsamplerConcat(in_ch, 16),
            DownsamplerConcat(16, 64),
            nn.Sequential(*[NonBottleneck1d(64, dropout=dropout_1)
                            for _ in range(5)]),
            DownsamplerConcat(64, 128),
            nn.Sequential(*[nn.Sequential(*[
                NonBottleneck1d(128, dilation=d, dropout=dropout_2)
                for d in (2, 4, 8, 16)]) for _ in range(2)]))
        self.decoder = nn.Sequential(
            UpsamplerBlock(128, 64),
            NonBottleneck1d(64), NonBottleneck1d(64),
            UpsamplerBlock(64, 16),
            NonBottleneck1d(16), NonBottleneck1d(16))
        self.head = enn.ConvTranspose(16, classes, 2, stride=2, bias=True)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The 16-channel half-resolution features under ``head``."""
        return self.decoder(self.encoder(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """The fused subpixel head on ``head``
        (``blocks.subpixel_predict_tail``): no full-resolution logits."""
        return subpixel_predict_tail(self.head, self.features(x))
