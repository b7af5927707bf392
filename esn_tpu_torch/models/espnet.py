"""ESPNet-C and ESPNet (Mehta et al. 2018, arXiv 1803.06815); counterpart of
``esn_tpu/models/espnet.py``.

ESP module: a 1x1 reduce (a 3x3 s2 conv when downsampling) to out/k ->
k parallel dilated 3x3 convs (d = 1, 2, 4, ..., the first taking the
remainder of the channels) -> hierarchical feature fusion (prefix sums of
the branches) -> concat -> residual -> BN PReLU. ESPNet-C is the encoder
with raw-input injections and a 1x1 classifier at 1/8 (``predict`` fuses
the x8 upsample + argmax); ESPNet puts a light decoder of 2x2 s2
transposed convs with level-wise skips on ESPNet-C's encoder (``enc``),
which ``train.checkpoint.load_encoder`` grafts from a trained ESPNet-C.

The reference's default re-associates the fusion into dense kernels
(``_fused_hff``) and can fold the reduce into them; both are rewrites for
its matrix unit and are not ported: this is its plain fusion, which those
rewrites equal up to f32 association. Its virtual-concat features are
``torch.cat`` here (exact in f32; in bf16 the reference rounds once per
piece), its scanned module chains ``Sequential`` (the same variable
paths). ESPNet's ``predict`` is the reference's fused subpixel head on
``up1`` (``blocks.subpixel_predict_tail``: K7 on the card), which never
builds the full-resolution logits.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import nn as enn
from ..ops import resize as R
from .blocks import BNAct, ConvBNAct, InputInjection, subpixel_predict_tail
from .registry import register

BN_EPS = 1e-3


class ESPModule(nn.Module):
    """k-way dilated spatial pyramid with hierarchical feature fusion;
    residual when the shapes allow."""

    def __init__(self, in_ch: int, out_ch: int, *, stride: int = 1, k: int = 5,
                 residual: bool = True):
        super().__init__()
        d = out_ch // k
        d1 = out_ch - d * (k - 1)
        self.k = k
        self.reduce = enn.Conv(in_ch, d, 3 if stride == 2 else 1,
                               stride=stride, padding=1 if stride == 2 else 0,
                               bias=False)
        for i in range(k):
            dil = 2 ** i
            setattr(self, f"d{i}", enn.Conv(d, d1 if i == 0 else d, 3,
                                            padding=dil, dilation=dil,
                                            bias=False))
        self.post = BNAct(out_ch, act="prelu", bn_eps=BN_EPS)
        self.residual = residual and stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.reduce(x)
        outs = [getattr(self, f"d{i}")(y) for i in range(self.k)]
        fused, acc = [outs[0]], None
        for i in range(1, self.k):
            acc = outs[i] if i == 1 else acc + outs[i]
            fused.append(acc)
        y = torch.cat(fused, dim=1)
        if self.residual:
            y = y + x
        return self.post(y)


@register("espnet_c", "espnetc")
class ESPNetC(enn.SegModel):
    """The encoder with a 1x1 classifier at 1/8; ``head=False`` leaves the
    classifier out (ESPNet's ``enc``)."""

    LOGITS_TAIL = "resize"

    def __init__(self, classes: int = 19, in_ch: int = 3, alpha2: int = 2,
                 alpha3: int = 8, head: bool = True):
        super().__init__()
        self.classes = classes
        self.stem = ConvBNAct(in_ch, 16, 3, stride=2, act="prelu",
                              bn_eps=BN_EPS)
        self.inj1 = InputInjection(1)
        self.inj2 = InputInjection(2)
        self.b1 = BNAct(16 + in_ch, act="prelu", bn_eps=BN_EPS)
        self.down1 = ESPModule(16 + in_ch, 64, stride=2, residual=False)
        self.level2 = nn.Sequential(*[ESPModule(64, 64)
                                      for _ in range(alpha2)])
        self.b2 = BNAct(128 + in_ch, act="prelu", bn_eps=BN_EPS)
        self.down2 = ESPModule(128 + in_ch, 128, stride=2, residual=False)
        self.level3 = nn.Sequential(*[ESPModule(128, 128)
                                      for _ in range(alpha3)])
        self.b3 = BNAct(256, act="prelu", bn_eps=BN_EPS)
        self.head = enn.Conv(256, classes, 1, bias=False) if head else None

    def encode(self, x: torch.Tensor):
        """The feature pyramid ``(f1, f2, f3)``: 16+3 channels at 1/2,
        128+3 at 1/4, 256 at 1/8."""
        f1 = self.b1(torch.cat([self.stem(x), self.inj1(x)], dim=1))
        d1 = self.down1(f1)                                       # 1/4, 64
        f2 = self.b2(torch.cat([self.level2(d1), d1, self.inj2(x)], dim=1))
        d2 = self.down2(f2)                                       # 1/8, 128
        f3 = self.b3(torch.cat([self.level3(d2), d2], dim=1))
        return f1, f2, f3

    def logits_lowres(self, x: torch.Tensor) -> torch.Tensor:
        """1/8-res logits (``predict`` fuses the x8 upsample + argmax)."""
        return self.head(self.encode(x)[2])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.logits_lowres(x)
        return R.resize_bilinear(y.float(), tuple(x.shape[2:])).to(y.dtype)


@register("espnet")
class ESPNet(enn.SegModel):
    """ESPNet-C's encoder and a light decoder with level-wise skips."""

    LOGITS_TAIL = "conv"

    def __init__(self, classes: int = 19, in_ch: int = 3, alpha2: int = 2,
                 alpha3: int = 8):
        super().__init__()
        self.classes = c = classes
        self.enc = ESPNetC(classes, in_ch, alpha2, alpha3, head=False)
        self.proj3 = ConvBNAct(256, c, 1, act="prelu", bn_eps=BN_EPS)
        self.up3 = enn.ConvTranspose(c, c, 2, stride=2, bias=False)
        self.proj2 = ConvBNAct(128 + in_ch, c, 1, act="prelu", bn_eps=BN_EPS)
        self.mix2 = ESPModule(2 * c, 2 * c, residual=False, k=4)
        self.up2 = enn.ConvTranspose(2 * c, c, 2, stride=2, bias=False)
        self.proj1 = ConvBNAct(16 + in_ch, c, 1, act="prelu", bn_eps=BN_EPS)
        self.mix1 = ConvBNAct(2 * c, c, 3, act="prelu", bn_eps=BN_EPS)
        self.up1 = enn.ConvTranspose(c, c, 2, stride=2, bias=False)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The ``classes``-channel half-resolution features under ``up1``."""
        f1, f2, f3 = self.enc.encode(x)
        y = self.up3(self.proj3(f3))                                  # 1/4
        y = self.up2(self.mix2(torch.cat([y, self.proj2(f2)], dim=1)))  # 1/2
        return self.mix1(torch.cat([y, self.proj1(f1)], dim=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up1(self.features(x))

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """The fused subpixel head on ``up1``
        (``blocks.subpixel_predict_tail``): no full-resolution logits."""
        return subpixel_predict_tail(self.up1, self.features(x))
