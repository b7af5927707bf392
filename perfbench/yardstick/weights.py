"""Weights made on the device from the seed, in a few large draws.

Convolutions: He-normal with fan-out (gain sqrt 2), their biases
``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``; dense layers torch's default
``U(-1/sqrt(in), 1/sqrt(in))`` for weight and bias; BN ``gamma ~ U(0.5,
1.5)``, ``beta ~ N(0, 0.1^2)``, running mean 0 and variance 1; PReLU
slopes 0.25. Every normal draw of the model comes from one ``randn`` and
every uniform draw from one ``rand``, taken in the order of the
reference model's ``state_dict``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from ..reference import layers as L
from .seeds import derive


def make_weights(model: nn.Module, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``model`` (a reference model, on any device,
    the meta device included)."""
    normal, uniform, const = [], [], {}
    for prefix, m in model.named_modules():
        name = (prefix + ".") if prefix else ""
        if isinstance(m, L.Conv):
            kh = kw = m.k
            fan_out = m.cout * kh * kw
            normal.append((name + "weight", m.weight.shape, 0.0,
                           math.sqrt(2.0 / fan_out)))
            if m.bias is not None:
                b = 1.0 / math.sqrt(kh * kw * m.cin // m.groups)
                uniform.append((name + "bias", m.bias.shape, -b, b))
        elif isinstance(m, L.Dense):
            b = 1.0 / math.sqrt(m.weight.shape[1])
            uniform.append((name + "weight", m.weight.shape, -b, b))
            uniform.append((name + "bias", m.bias.shape, -b, b))
        elif isinstance(m, L.BatchNorm):
            c = m.weight.shape[0]
            uniform.append((name + "weight", (c,), 0.5, 1.5))
            normal.append((name + "bias", (c,), 0.0, 0.1))
            const[name + "running_mean"] = (c, 0.0)
            const[name + "running_var"] = (c, 1.0)
        elif isinstance(m, L.PReLU):
            const[name + "weight"] = (m.weight.shape[0], 0.25)
    g = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    out: Dict[str, torch.Tensor] = {}
    for draws, fn in ((normal, torch.randn), (uniform, torch.rand)):
        total = sum(math.prod(s) for _, s, _, _ in draws)
        flat = fn((total,), generator=g, device=device)
        at = 0
        for key, shape, a, b in draws:
            k = math.prod(shape)
            v = flat[at:at + k].reshape(shape)
            out[key] = v * b + a if fn is torch.randn else a + (b - a) * v
            at += k
    for key, (c, v) in const.items():
        out[key] = torch.full((c,), v, device=device)
    missing = set(model.state_dict()) - set(out)
    if missing:
        raise KeyError(f"no rule for {sorted(missing)[:5]}")
    return {k: out[k] for k in model.state_dict()}
