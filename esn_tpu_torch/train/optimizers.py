"""Optimizer factory (counterpart of ``esn_tpu/train/optimizers.py``).

The reference's optax chains map onto ``torch.optim`` with the same
semantics: ``sgd`` and ``adam`` add L2 weight decay to the gradient
before the transform (``add_decayed_weights`` first in the chain, as
``torch.optim.SGD``/``Adam(weight_decay=...)`` do), ``adamw`` decays
decoupled from the adaptive step. SGD is heavy-ball momentum without
dampening or Nesterov (``optax.trace``). The learning rate starts at 0:
the train step sets it from its schedule before each
``optimizer.step()`` (without a schedule, set ``param_groups``' ``lr``).
"""
from __future__ import annotations

from typing import Iterable

import torch


def build_optimizer(name: str, params: Iterable[torch.nn.Parameter], *,
                    weight_decay: float = 1e-4, momentum: float = 0.9,
                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                    ) -> torch.optim.Optimizer:
    """The reference's ``--optim`` flag: ``sgd``, ``adam`` or ``adamw``."""
    name = name.lower()
    params = list(params)
    if name == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=momentum, dampening=0,
                               nesterov=False, weight_decay=weight_decay)
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(b1, b2), eps=eps,
                                weight_decay=weight_decay)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(b1, b2), eps=eps,
                                 weight_decay=weight_decay)
    raise KeyError(f"unknown optimizer {name!r}; options: sgd adam adamw")
