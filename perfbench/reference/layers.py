"""Plain PyTorch layers of the benchmark's reference models.

Float32 NCHW, no fused path, no hand-written kernel, nothing imported
from the program under test. Attribute names follow the program's
``state_dict`` keys, so one dictionary of weights loads into both.

Convolutions, dense layers, BNs and activations round through the
model's :class:`Numerics`: not at all by default, or to float8 (the
control that a lower precision than the configuration's bfloat16 must
fail). :class:`Resize` and
:class:`AdaptivePool` are modules so that forward hooks see their shapes
(``perfbench.yardstick.shapes``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0            # the largest finite float8 e4m3 value
FP8_E5M2_MAX = 57344.0     # and e5m2


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``t`` rounded to the float8 ``dtype``, scaled per tensor so that
    its largest magnitude maps to ``top``."""
    scale = torch.clamp(t.abs().amax(), min=1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Float8(torch.autograd.Function):
    """Values rounded to e4m3, their gradients to e5m2 (the usual float8
    training recipe)."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, FP8_E5M2_MAX)


class Numerics:
    """Where a reference model rounds: ``"f32"`` (nowhere) or ``"fp8"``
    (the control): the operands and the output of every convolution and
    dense layer, and the output of every BN and activation, rounded to
    float8 e4m3 and their gradients to e5m2, each scaled per tensor; the
    arithmetic between stays f32. The program in bfloat16 rounds at the
    same points (and more) to 8 significant bits; this rounds to 4 (3 for
    the gradients)."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"numerics {kind!r}: f32 or fp8")
        self.kind = kind

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.kind == "f32" else _Float8.apply(t)


def set_numerics(model: nn.Module, numerics: Numerics) -> None:
    for m in model.modules():
        if hasattr(m, "numerics"):
            m.numerics = numerics


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv(nn.Module):
    """2-D convolution, OIHW weight."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1,
                 bias: bool = True):
        super().__init__()
        self.cin, self.cout, self.k = cin, cout, k
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.numerics = Numerics()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.numerics
        return q(F.conv2d(q(x), q(self.weight), self.bias, self.stride,
                          self.padding, self.dilation, self.groups))


class Dense(nn.Module):
    """Fully connected layer, ``(out, in)`` weight and a bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))
        self.numerics = Numerics()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.numerics
        return q(q(x) @ q(self.weight).t() + self.bias)


class BatchNorm(nn.Module):
    """Batch normalisation. Training normalises with the batch's mean and
    biased variance and moves the running statistics by ``momentum``
    toward the batch mean and the unbiased variance; eval normalises with
    the running statistics."""

    def __init__(self, c: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.numerics = Numerics()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = (x - mean[:, None, None]).square().mean(dim=(0, 2, 3))
            n = x.shape[0] * x.shape[2] * x.shape[3]
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(m * mean.detach())
                self.running_var.mul_(1 - m).add_(
                    m * var.detach() * (n / max(n - 1, 1)))
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight / torch.sqrt(var + self.eps)
        return self.numerics((x - mean[:, None, None]) * scale[:, None, None]
                             + self.bias[:, None, None])


class PReLU(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((c,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight[:, None, None] * x)


def activation(kind: str, c: int) -> Optional[nn.Module]:
    if kind == "none":
        return None
    if kind == "relu":
        return nn.ReLU()
    if kind == "relu6":
        return nn.Hardtanh(0.0, 6.0)
    if kind == "prelu":
        return PReLU(c)
    raise KeyError(kind)


class ConvBNAct(nn.Module):
    """conv (no bias) -> BN -> activation, "same" padding at stride 1."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1,
                 dilation: int = 1, groups: int = 1, act: str = "relu",
                 eps: float = 1e-5):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride=stride,
                         padding=dilation * (k - 1) // 2, dilation=dilation,
                         groups=groups, bias=False)
        self.bn = BatchNorm(cout, eps)
        self.act = activation(act, cout)
        self.numerics = Numerics()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(self.conv(x))
        return self.numerics(self.act(y)) if self.act is not None else y


class BNAct(nn.Module):
    def __init__(self, c: int, act: str = "prelu", eps: float = 1e-5):
        super().__init__()
        self.bn = BatchNorm(c, eps)
        self.act = activation(act, c)
        self.numerics = Numerics()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(x)
        return self.numerics(self.act(y)) if self.act is not None else y


class Resize(nn.Module):
    """Bilinear resize with half-pixel centres (``align_corners=False``),
    no antialias, to ``size``."""

    def forward(self, x: torch.Tensor, size) -> torch.Tensor:
        if tuple(size) == tuple(x.shape[2:]):
            return x
        return F.interpolate(x, size=tuple(size), mode="bilinear",
                             align_corners=False)


class AdaptivePool(nn.Module):
    """Adaptive average pool to ``bins`` x ``bins``."""

    def __init__(self, bins: int):
        super().__init__()
        self.bins = bins

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.adaptive_avg_pool2d(x, self.bins)


class Dropout(nn.Module):
    """Element dropout (``channel=False``) or channel dropout. In training
    the uniform draws come from ``self.draw(shape)``, which the caller
    sets; without one (the statistics pass) it passes its input on."""

    def __init__(self, rate: float, channel: bool = False):
        super().__init__()
        self.rate, self.channel = rate, channel
        self.draw: Optional[Callable] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0 or self.draw is None:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0], x.shape[1], 1, 1) if self.channel \
            else tuple(x.shape)
        u = self.draw(shape)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class Stage(nn.Sequential):
    """Blocks in a row; with ``recompute`` set and gradients recorded,
    each block's forward runs again in the backward instead of keeping
    its activations (``torch.utils.checkpoint``), so that the f32
    reference of a large training step fits beside its inputs. Only
    blocks that draw nothing may recompute."""

    recompute = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self:
            if self.recompute and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        return x


class ReferenceModel(nn.Module):
    """A segmentation model whose forward ends in an x8 bilinear upsample
    of ``logits_lowres``."""

    def logits_lowres(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail(self.logits_lowres(x), x.shape[2:])
