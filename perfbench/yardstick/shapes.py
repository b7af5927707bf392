"""The shapes of a reference model's layers at a cell's sizes, from a
forward (and, for training, a backward) on the meta device: no memory,
no arithmetic."""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from ..reference import layers as L


def _shape(v):
    return tuple(v.shape) if isinstance(v, torch.Tensor) else v


def meta_model(build, classes: int) -> nn.Module:
    with torch.device("meta"):
        return build(classes)


def layer_calls(model: nn.Module, batch: int, hw, train: bool
                ) -> List[Dict]:
    """One record a module call of a forward at ``(batch, 3, *hw)``: the
    module's class and path, its inputs' and output's shapes, and the
    module itself (for its attributes)."""
    calls: List[Dict] = []
    hooks = []
    for name, m in model.named_modules():
        def hook(mod, args, out, name=name):
            calls.append({"cls": type(mod).__name__, "name": name,
                          "args": [_shape(a) for a in args],
                          "out": _shape(out), "module": mod})
        hooks.append(m.register_forward_hook(hook))
    model.train(train)
    try:
        with torch.no_grad():
            model(torch.empty((batch, 3, *hw), device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return calls


def model_flops(model: nn.Module, batch: int, hw, train: bool) -> int:
    """FLOPs of the products (convolutions and dense layers; 2 a
    multiply-add) of one forward at ``(batch, 3, *hw)``, as
    ``torch.utils.flop_counter`` counts them, or for ``train`` of a
    forward and its backward: three times the forward, less the input
    gradient of the layers that read the image (nothing asks for it).
    The backward is not counted by ``FlopCounterMode`` itself, whose
    formula for a grouped convolution's backward counts it as a dense
    one (``groups`` times too many)."""
    model.train(train)
    x = torch.empty((batch, 3, *hw), device="meta")
    first = []

    def hook(mod, args, out):
        if args[0] is x:      # a conv on the image: 2 a multiply-add
            first.append(2 * out.numel() * mod.weight[0].numel())
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (L.Conv, L.Dense))]
    try:
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    forward = int(counter.get_total_flops())
    return 3 * forward - int(sum(first)) if train else forward
