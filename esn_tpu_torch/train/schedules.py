"""Learning-rate schedules (counterpart of ``esn_tpu/train/schedules.py``).

Plain ``step -> lr`` functions of the step count, stepped per iteration
with ``T = max_epochs * iters_per_epoch``: 'poly' (``(1 - t/T)^power``),
'warmpoly' (linear warmup from ``warmup_factor`` over ``warmup_steps``,
then poly) and 'constant'. The train step applies ``lr(step)`` at the
step's current count, starting at 0, as ``optax.scale_by_learning_rate``
does.
"""
from __future__ import annotations

from typing import Callable

Schedule = Callable[[int], float]


def _clip01(v: float) -> float:
    return min(max(v, 0.0), 1.0)


def poly_schedule(base_lr: float, total_steps: int,
                  power: float = 0.9) -> Schedule:
    total = max(total_steps, 1)

    def schedule(step: int) -> float:
        return base_lr * (1.0 - _clip01(step / total)) ** power

    return schedule


def warmup_poly_schedule(base_lr: float, total_steps: int, power: float = 0.9,
                         warmup_steps: int = 500,
                         warmup_factor: float = 1.0 / 3.0) -> Schedule:
    total = max(total_steps, 1)
    warmup_steps = max(int(warmup_steps), 0)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            alpha = _clip01(step / warmup_steps)
            return base_lr * (warmup_factor * (1.0 - alpha) + alpha)
        return base_lr * (1.0 - _clip01(step / total)) ** power

    return schedule


def constant_schedule(base_lr: float) -> Schedule:
    return lambda step: float(base_lr)


def build_schedule(name: str, base_lr: float, total_steps: int, *,
                   power: float = 0.9, warmup_steps: int = 500,
                   warmup_factor: float = 1.0 / 3.0) -> Schedule:
    """The reference's ``--lr_schedule {poly, warmpoly}`` flags."""
    if name == "poly":
        return poly_schedule(base_lr, total_steps, power)
    if name in ("warmpoly", "warmup_poly"):
        return warmup_poly_schedule(base_lr, total_steps, power,
                                    warmup_steps, warmup_factor)
    if name in ("constant", "fixed"):
        return constant_schedule(base_lr)
    raise KeyError(f"unknown lr schedule {name!r}")
