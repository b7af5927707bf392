"""Shared blocks (counterpart of the Fast-SCNN and CGNet part of
``esn_tpu/models/blocks.py``). NCHW; convs feeding BN carry no bias.
Submodule names equal the reference's scope names."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .. import nn as enn
from ..ops import kernels as K
from ..ops import pooling as P
from ..ops import resize as R

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
    """conv (no bias, "same" padding) -> BN (``bn_eps``) -> activation."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, *,
                 stride: int = 1, groups: int = 1, act: str = "prelu",
                 bn_eps: float = 1e-5):
        super().__init__()
        self.conv = enn.Conv(in_ch, out_ch, kernel, stride=stride,
                             padding=(kernel - 1) // 2, groups=groups,
                             bias=False)
        self.bn = enn.BatchNorm(out_ch, eps=bn_eps)
        self.act = _act_module(act, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class BNAct(nn.Module):
    """BN -> PReLU."""

    def __init__(self, ch: int, *, bn_eps: float):
        super().__init__()
        self.bn = enn.BatchNorm(ch, eps=bn_eps)
        self.act = enn.PReLU(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(x))


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
    concat, 1x1 fuse. Reducers are ``reduce0..reduce{n-1}``."""

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
        feats = [x]
        for i, b in enumerate(self.bins):
            y = getattr(self, f"reduce{i}")(P.adaptive_avg_pool2d(x, b))
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
