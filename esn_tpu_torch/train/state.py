"""The train state (counterpart of ``esn_tpu/train/state.py``).

The reference carries one pytree: params, BN stats, the optimizer state
and the step. Here the model holds its parameters and BN running
statistics, the ``torch.optim`` optimizer its moments, and the step count
(which is also the LR schedule's position: a schedule is a function of
it) is an int. :class:`TrainState` names the three for checkpoints; the
:class:`~esn_tpu_torch.train.step.TrainStep` that trains them keeps the
live count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": int(self.step)}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore in place (the optimizer's tensors move to its
        parameters' device)."""
        self.model.load_state_dict(sd["model"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])
