"""ESNet (Wang et al. 2019, arXiv 1906.09826); counterpart of
``esn_tpu/models/esnet.py``.

Symmetric encoder-decoder. Encoder: down(3->16), 3x FCU(16, k3);
down(16->64), 2x FCU(64, k5); down(64->128), 3x PFCU(128, d = 2, 5, 9).
Decoder: up(128->64), 2x FCU(64, k5); up(64->16), 2x FCU(16, k3); a 2x2
stride-2 transposed conv -> classes. An FCU is ERFNet's non-bottleneck
unit at kernel k.

``predict`` is the reference's fused subpixel head on ``head``
(``blocks.subpixel_predict_tail``: K7 on the card), which never builds
the full-resolution logits; its scanned chains are ``nn.Sequential``
(the same variable paths).
"""
from __future__ import annotations

import torch
from torch import nn

from .. import nn as enn
from .blocks import (DownsamplerConcat, NonBottleneck1d, UpsamplerBlock,
                     subpixel_predict_tail)
from .registry import register


class PFCU(nn.Module):
    """Parallel factorized unit: a shared (3x1 -> relu -> 1x3 -> BN relu)
    head, then three dilated (3x1 -> relu -> 1x3 -> BN) branches (d = 2,
    5, 9) summed, spatial dropout, residual, relu. Biased convs, BN eps
    1e-3; branch i is ``b{i}_1``, ``b{i}_2``, ``b{i}_bn``."""

    def __init__(self, ch: int, dilations=(2, 5, 9), dropout: float = 0.3):
        super().__init__()
        self.h1 = enn.Conv(ch, ch, (3, 1), padding=(1, 0), bias=True)
        self.h2 = enn.Conv(ch, ch, (1, 3), padding=(0, 1), bias=True)
        self.bn_head = enn.BatchNorm(ch, eps=1e-3)
        self.n_branches = len(dilations)
        for i, d in enumerate(dilations):
            setattr(self, f"b{i}_1", enn.Conv(ch, ch, (3, 1), padding=(d, 0),
                                              dilation=(d, 1), bias=True))
            setattr(self, f"b{i}_2", enn.Conv(ch, ch, (1, 3), padding=(0, d),
                                              dilation=(1, d), bias=True))
            setattr(self, f"b{i}_bn", enn.BatchNorm(ch, eps=1e-3))
        self.drop = enn.SpatialDropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = enn.relu(self.bn_head(self.h2(enn.relu(self.h1(x)))))
        total = None
        for i in range(self.n_branches):
            b = enn.relu(getattr(self, f"b{i}_1")(y))
            b = getattr(self, f"b{i}_bn")(getattr(self, f"b{i}_2")(b))
            total = b if total is None else total + b
        return enn.relu(x + self.drop(total))


@register("esnet")
class ESNet(enn.SegModel):
    LOGITS_TAIL = "conv"

    def __init__(self, classes: int = 19, in_ch: int = 3):
        super().__init__()
        self.classes = classes
        self.encoder = nn.Sequential(
            DownsamplerConcat(in_ch, 16, act="relu"),
            nn.Sequential(*[NonBottleneck1d(16, k=3, dropout=0.03)
                            for _ in range(3)]),
            DownsamplerConcat(16, 64, act="relu"),
            nn.Sequential(*[NonBottleneck1d(64, k=5, dropout=0.03)
                            for _ in range(2)]),
            DownsamplerConcat(64, 128, act="relu"),
            nn.Sequential(*[PFCU(128) for _ in range(3)]))
        self.decoder = nn.Sequential(
            UpsamplerBlock(128, 64),
            nn.Sequential(*[NonBottleneck1d(64, k=5) for _ in range(2)]),
            UpsamplerBlock(64, 16),
            nn.Sequential(*[NonBottleneck1d(16, k=3) for _ in range(2)]))
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
