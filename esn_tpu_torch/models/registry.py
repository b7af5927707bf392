"""Model factory (counterpart of ``esn_tpu/models/registry.py``).

``build_model(name, num_classes)`` returns an initialised ``SegModel`` in
``channels_last`` memory on ``device`` (the CUDA device unless the caller
asks for the CPU); names are case-insensitive and aliases resolve to the
canonical name.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..nn import SegModel

_REGISTRY: Dict[str, Callable[..., SegModel]] = {}
_ALIASES: Dict[str, str] = {}


def register(name: str, *aliases: str):
    def deco(ctor):
        _REGISTRY[name.lower()] = ctor
        for a in aliases:
            _ALIASES[a.lower()] = name.lower()
        return ctor
    return deco


def available_models():
    return sorted(_REGISTRY)


def build_model(model_name: str, num_classes: int, *,
                device: Optional[torch.device | str] = None,
                generator: Optional[torch.Generator] = None,
                **kwargs) -> SegModel:
    """Build, initialise from ``generator`` (a CPU generator; seed 0 when
    None) and move to ``device``: the CUDA device when None, so a machine
    without one raises unless the caller asks for ``device="cpu"``."""
    key = model_name.lower()
    key = _ALIASES.get(key, key)
    if key not in _REGISTRY:
        raise KeyError(f"unknown model {model_name!r}; "
                       f"available: {available_models()}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_model: no CUDA device; pass "
                               "device='cpu' to build on the CPU")
        device = "cuda"
    model = _REGISTRY[key](classes=num_classes, **kwargs)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model.init_weights(generator)
    return model.to(device=device, memory_format=torch.channels_last)
