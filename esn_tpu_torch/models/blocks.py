"""Shared blocks (counterpart of the plain paths of
``esn_tpu/models/blocks.py``). NCHW; convs feeding BN carry no bias.
Submodule names equal the reference's scope names."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .. import nn as enn
from ..nn.layers import IntOr2, _pair
from ..ops import classify as CL
from ..ops import kernels as K
from ..ops import pooling as P
from ..ops import resize as R
from ..parallel import spatial


def _act_module(act: Optional[str], ch: int) -> Optional[nn.Module]:
    if act is None or act == "none":
        return None
    if act == "relu":
        return nn.ReLU()
    if act == "relu6":
        return nn.ReLU6()
    if act == "prelu":
        return enn.PReLU(ch)
    if act == "prelu1":
        return enn.PReLU(1)
    raise KeyError(act)


class ConvBNAct(nn.Module):
    """conv -> BN (``bn_eps``) -> activation. ``padding`` None is "same"
    for stride 1, ``dilation * (k - 1) // 2`` per axis; the conv carries a
    bias only without BN unless ``bias`` says otherwise; ``bn=False`` drops
    the BN (``self.bn`` is None)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: IntOr2 = 3, *,
                 stride: IntOr2 = 1, padding: Optional[IntOr2] = None,
                 dilation: IntOr2 = 1, groups: int = 1, act: str = "prelu",
                 bn: bool = True, bias: Optional[bool] = None,
                 bn_eps: float = 1e-5):
        super().__init__()
        if padding is None:
            (kh, kw), (dh, dw) = _pair(kernel), _pair(dilation)
            ph, pw = dh * (kh - 1) // 2, dw * (kw - 1) // 2
            padding = ph if ph == pw else (ph, pw)
        self.conv = enn.Conv(in_ch, out_ch, kernel, stride=stride,
                             padding=padding, dilation=dilation,
                             groups=groups,
                             bias=(not bn) if bias is None else bias)
        self.bn = enn.BatchNorm(out_ch, eps=bn_eps) if bn else None
        self.act = _act_module(act, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x) if self.act is not None else x


class BNAct(nn.Module):
    """BN -> activation (PReLU by default)."""

    def __init__(self, ch: int, act: str = "prelu", *, bn_eps: float = 1e-5):
        super().__init__()
        self.bn = enn.BatchNorm(ch, eps=bn_eps)
        self.act = _act_module(act, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(x)
        return self.act(x) if self.act is not None else x


class DSConv(nn.Module):
    """Depthwise-separable conv: dw 3x3 (stride 1 or 2) + pw 1x1, each
    BN + ReLU.

    In eval mode the whole block is one call of the ``fused_dsconv``
    kernel with both BNs folded into affines (the plain ``dsconv_ref`` for
    a CPU tensor). Training runs the composed dw -> pw path.
    """

    def __init__(self, in_ch: int, out_ch: int, *, stride: int = 1):
        super().__init__()
        self.in_ch, self.out_ch, self.stride = in_ch, out_ch, stride
        self.dw = ConvBNAct(in_ch, in_ch, 3, stride=stride, groups=in_ch,
                            act="relu")
        self.pw = ConvBNAct(in_ch, out_ch, 1, act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self.forward_composed(x)
        return self.forward_fused(x)

    def forward_composed(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(self.dw(x))

    def forward_fused(self, x: torch.Tensor) -> torch.Tensor:
        ci, co = self.in_ch, self.out_ch
        dbn, pbn = self.dw.bn, self.pw.bn
        a1, b1 = K.fold_bn(dbn.running_mean, dbn.running_var, dbn.weight,
                           dbn.bias, dbn.eps)
        a2, b2 = K.fold_bn(pbn.running_mean, pbn.running_var, pbn.weight,
                           pbn.bias, pbn.eps)
        dwk = self.dw.conv.weight.reshape(ci, 3, 3).permute(1, 2, 0)
        pwk = self.pw.conv.weight.reshape(co, ci).t()
        y = K.fused_dsconv(x.permute(0, 2, 3, 1).contiguous(), dwk, a1, b1,
                           pwk, a2, b2, stride=self.stride, act1="relu",
                           act2="relu")
        return y.permute(0, 3, 1, 2)


class InvertedResidual(nn.Module):
    """MobileNetV2 linear bottleneck: 1x1 expand -> dw 3x3 -> 1x1 project
    (linear), residual when stride 1 and shapes match."""

    def __init__(self, in_ch: int, out_ch: int, *, expansion: int = 6,
                 stride: int = 1, act: str = "relu6"):
        super().__init__()
        mid = in_ch * expansion
        self.use_res = stride == 1 and in_ch == out_ch
        self.expand = (ConvBNAct(in_ch, mid, 1, act=act) if expansion != 1
                       else None)
        self.dw = ConvBNAct(mid, mid, 3, stride=stride, groups=mid, act=act)
        self.project = ConvBNAct(mid, out_ch, 1, act="none")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.expand(x) if self.expand is not None else x
        y = self.project(self.dw(y))
        return x + y if self.use_res else y


class PyramidPooling(nn.Module):
    """PPM: adaptive-avg-pool to ``bins``, 1x1 reduce, bilinear upsample,
    concat, 1x1 fuse. Reducers are ``reduce0..reduce{n-1}``.

    Under spatial sharding the branches pool the whole map, gathered
    once from the model group (``spatial.whole``), so every pooled value
    is the one-process value bit for bit: each is read by a whole bin of
    pixels, and in bf16 a value summed in another order can round one
    ulp apart and move the loss by ~1e-4 (pooling the shards' sums over
    the group does). The pooled maps are replicated: their reduce and
    upsample run marked as such (``spatial.replicated``), and the
    upsample gives this rank's rows."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 bins: Sequence[int] = (1, 2, 3, 6), act: str = "relu"):
        super().__init__()
        out_ch = out_ch or in_ch
        self.bins = tuple(bins)
        red = in_ch // len(bins)
        for i in range(len(self.bins)):
            setattr(self, f"reduce{i}", ConvBNAct(in_ch, red, 1, act=act))
        self.fuse = ConvBNAct(in_ch + red * len(bins), out_ch, 1, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2:]
        feats, full = [x], spatial.whole(x)
        with spatial.replicated():
            for i, b in enumerate(self.bins):
                y = getattr(self, f"reduce{i}")(P.adaptive_avg_pool2d(full, b))
                feats.append(R.resize_bilinear(y, (h, w)))
        return self.fuse(torch.cat(feats, dim=1))


class SEGate(nn.Module):
    """Squeeze-excite channel gate: GAP -> FC -> ReLU -> FC -> sigmoid ->
    scale."""

    def __init__(self, ch: int, reduction: int = 16):
        super().__init__()
        mid = max(ch // reduction, 1)
        self.fc1 = enn.Dense(ch, mid)
        self.fc2 = enn.Dense(mid, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = P.global_avg_pool(x, keepdims=False)        # (N, C), x's dtype
        return x * self.gate(s)[:, :, None, None]

    def gate(self, s: torch.Tensor) -> torch.Tensor:
        """Gate vector (N, C) from a pooled mean (N, C) in x's dtype, for
        fused paths that already hold the spatial sum."""
        return torch.sigmoid(self.fc2(enn.relu(self.fc1(s))))


class InputInjection(nn.Module):
    """``times`` cascaded 3x3 stride-2 average pools (padding 1, padded
    zeros counted) of the raw input."""

    def __init__(self, times: int):
        super().__init__()
        self.times = times

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.times):
            x = P.avg_pool2d(x, 3, 2, 1)
        return x


def channel_split(x: torch.Tensor):
    """The two channel halves of x (views)."""
    c = x.shape[1] // 2
    return x[:, :c], x[:, c:]


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """ShuffleNet's channel shuffle: output channel ``j * groups + i`` is
    input channel ``i * (C // groups) + j``; taken in NHWC, so the output
    is channels_last."""
    n, c, h, w = x.shape
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    y = x.permute(0, 2, 3, 1).reshape(n, h, w, groups, c // groups)
    return y.transpose(3, 4).reshape(n, h, w, c).permute(0, 3, 1, 2)


class DownsamplerConcat(nn.Module):
    """conv 3x3 s2 (bias) || 2x2 max pool -> concat -> BN + act (ERFNet's
    DownsamplerBlock). When ``out_ch <= in_ch`` the conv makes all
    ``out_ch`` channels and nothing is pooled."""

    def __init__(self, in_ch: int, out_ch: int, act: str = "relu",
                 bn_eps: float = 1e-3):
        super().__init__()
        self.concat_pool = out_ch > in_ch
        conv_out = out_ch - in_ch if self.concat_pool else out_ch
        self.conv = enn.Conv(in_ch, conv_out, 3, stride=2, padding=1,
                             bias=True)
        self.post = BNAct(out_ch, act, bn_eps=bn_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.concat_pool:
            y = torch.cat([y, P.max_pool2d(x, 2, 2)], dim=1)
        return self.post(y)


class NonBottleneck1d(nn.Module):
    """ERFNet's factorised residual unit: (kx1 -> relu -> 1xk -> BN relu)
    then the dilated pair (kx1 -> relu -> 1xk -> BN), spatial dropout,
    residual add, relu. Biased convs, BN eps 1e-3."""

    def __init__(self, ch: int, k: int = 3, *, dilation: int = 1,
                 dropout: float = 0.0, bn_eps: float = 1e-3):
        super().__init__()
        pad, d = (k - 1) // 2, dilation
        self.p1a = enn.Conv(ch, ch, (k, 1), padding=(pad, 0), bias=True)
        self.p1b = enn.Conv(ch, ch, (1, k), padding=(0, pad), bias=True)
        self.bn1 = enn.BatchNorm(ch, eps=bn_eps)
        self.p2a = enn.Conv(ch, ch, (k, 1), padding=(pad * d, 0),
                            dilation=(d, 1), bias=True)
        self.p2b = enn.Conv(ch, ch, (1, k), padding=(0, pad * d),
                            dilation=(1, d), bias=True)
        self.bn2 = enn.BatchNorm(ch, eps=bn_eps)
        self.drop = enn.SpatialDropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.p1b(enn.relu(self.p1a(x)))
        y = enn.relu(self.bn1(y))
        y = self.p2b(enn.relu(self.p2a(y)))
        y = self.drop(self.bn2(y))
        return enn.relu(x + y)


class UpsamplerBlock(nn.Module):
    """3x3 stride-2 transposed conv (bias, output padding 1) -> BN + act."""

    def __init__(self, in_ch: int, out_ch: int, act: str = "relu",
                 bn_eps: float = 1e-3):
        super().__init__()
        self.deconv = enn.ConvTranspose(in_ch, out_ch, 3, stride=2, padding=1,
                                        output_padding=1, bias=True)
        self.post = BNAct(out_ch, act, bn_eps=bn_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.post(self.deconv(x))


def subpixel_predict_tail(layer: enn.ConvTranspose,
                          y: torch.Tensor) -> torch.Tensor:
    """Finish a model whose last layer is the transposed conv ``layer``
    with the fused prediction head (counterpart of the reference's
    ``blocks.subpixel_predict_tail``): the class argmax per subpixel
    phase, the int32 indices put in place (``ops.classify.subpixel_argmax``:
    K7 on the card, its plain version on the CPU), so the
    full-resolution logits never exist. y: the layer's NCHW input. A
    geometry the decomposition does not cover
    (``ConvTranspose.subpixel_eligible``: the output not ``s`` times the
    input) takes the argmax of the layer's full output, where the
    reference does too; that is the reference's geometry rule, not a
    fallback for a failed kernel."""
    if layer.subpixel_eligible():
        return CL.subpixel_argmax(y.permute(0, 2, 3, 1), layer.weight,
                                  layer.bias, stride=_pair(layer.stride),
                                  padding=_pair(layer.padding))
    return CL.argmax_lastdim(layer(y).permute(0, 2, 3, 1))
