"""Weight initializers (counterpart of ``esn_tpu/nn/initializers.py``).

Kaiming-normal fan-out for convs, BN gamma=1 / beta=0, torch's fan-in
uniform bias and Dense kernel. Every initializer is
``f(generator, shape) -> tensor`` and draws on the CPU from an explicit
``torch.Generator``, so a seed gives the same weights whatever device the
model later lives on. The JAX init folds
a hash of the scope path into its key, so the two packages never draw the
same numbers: parity tests convert weights (``esn_tpu_torch.convert``).

Conv shapes here are torch's OIHW (out, in_per_group, kh, kw); Dense
kernels are (out, in).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


def zeros(generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    return torch.zeros(tuple(shape))


def ones(generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    return torch.ones(tuple(shape))


def _conv_fans(shape):
    # OIHW: receptive field * in channels (per group) / * out channels
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return receptive * shape[1], receptive * shape[0]


def kaiming_normal(mode: str = "fan_out", gain: float = math.sqrt(2.0)):
    """He-normal with gain sqrt(2) (ReLU family), as the reference convs."""
    def init(generator, shape):
        fan_in, fan_out = _conv_fans(shape)
        fan = fan_out if mode == "fan_out" else fan_in
        std = gain / math.sqrt(max(fan, 1))
        return torch.randn(tuple(shape), generator=generator) * std
    return init


def torch_conv_default(generator: torch.Generator,
                       shape: Sequence[int]) -> torch.Tensor:
    """torch.nn.Conv2d/Linear default: U(-b, b), b = 1/sqrt(fan_in)."""
    fan_in, _ = _conv_fans(shape)
    return uniform_bound(1.0 / math.sqrt(max(fan_in, 1)))(generator, shape)


def uniform_bound(bound: float):
    def init(generator, shape):
        return (torch.rand(tuple(shape), generator=generator) * 2 - 1) * bound
    return init


def bias_for_fan_in(fan_in: int):
    """torch default bias init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return uniform_bound(1.0 / math.sqrt(max(fan_in, 1)))
