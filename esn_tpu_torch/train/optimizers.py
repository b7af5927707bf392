"""Optimizer factory (counterpart of ``esn_tpu/train/optimizers.py``).

The reference's optax chains map onto ``torch.optim`` with the same
semantics: ``sgd``, ``adam``, ``radam`` and ``ranger`` add L2 weight
decay to the gradient before the transform (``add_decayed_weights`` first
in the chain, as ``torch.optim.SGD``/``Adam(weight_decay=...)`` do),
``adamw`` decays decoupled from the adaptive step. SGD is heavy-ball
momentum without dampening or Nesterov (``optax.trace``). ``radam`` is
:class:`RAdam`, optax's ``scale_by_radam`` (not ``torch.optim.RAdam``,
whose update differs from it); ``ranger`` is :class:`Ranger`, the
reference's ``lookahead`` over that RAdam. The learning rate starts at 0:
the train step sets it from its schedule before each ``optimizer.step()``
(without a schedule, set ``param_groups``' ``lr``).
"""
from __future__ import annotations

from typing import Iterable, List

import torch


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


class RAdam(torch.optim.Optimizer):
    """Rectified Adam with optax's ``scale_by_radam`` formula: with
    ``m̂``, ``v̂`` the bias-corrected moments and ``ρ_t = ρ_∞ − 2t·β₂ᵗ/(1 −
    β₂ᵗ)``, the update is ``−lr·r_t·m̂/(√v̂ + eps)`` where ``ρ_t >=
    THRESHOLD`` and ``−lr·m̂`` below it (``torch.optim.RAdam`` divides by
    ``(√v + eps)/√(1 − β₂ᵗ)`` and switches on ``ρ_t > 5``). ``β₂ᵗ``,
    ``ρ_t``, ``r_t`` and the bias corrections are computed in f32 with
    optax's operations, so the step at which ``ρ_t`` first reaches
    ``THRESHOLD`` (the sixth, at β₂ = 0.999) and ``r_t`` are optax's.
    ``weight_decay`` adds ``wd·p`` to the gradient first.

    Per-parameter state: ``step``, ``exp_avg``, ``exp_avg_sq``, as
    ``torch.optim.Adam``'s (optax's ``count``, ``mu``, ``nu``).
    """

    THRESHOLD = 5.0

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float = 0.0,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @staticmethod
    def _count(states) -> int:
        counts = {int(s["step"]) for s in states}
        if len(counts) != 1:
            raise ValueError(f"parameters at different steps: {counts}")
        return counts.pop()

    def _update(self, group) -> List[torch.nn.Parameter]:
        """One RAdam step of ``group``'s parameters that have a gradient;
        returns them."""
        params = [p for p in group["params"] if p.grad is not None]
        if not params:
            return params
        for p in params:
            state = self.state[p]
            if "step" not in state:
                state["step"] = torch.tensor(0.0)
                state["exp_avg"] = torch.zeros_like(p)
                state["exp_avg_sq"] = torch.zeros_like(p)
        states = [self.state[p] for p in params]
        t = self._count(states) + 1
        b1, b2 = group["betas"]
        grads = [p.grad for p in params]
        if group["weight_decay"]:
            grads = torch._foreach_add(grads, params,
                                       alpha=group["weight_decay"])
        ms = [s["exp_avg"] for s in states]
        vs = [s["exp_avg_sq"] for s in states]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, grads, alpha=1.0 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, grads, grads, value=1.0 - b2)
        for s in states:
            s["step"].fill_(t)
        # optax's scalars, in f32 (its count is int32, β^count f32)
        tf = _f32(t)
        b2t = torch.pow(_f32(b2), tf)
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        rho = _f32(rho_inf) - (2 * t) * b2t / (1 - b2t)
        update = torch._foreach_div(ms, float(1 - torch.pow(_f32(b1), tf)))
        if float(rho) >= self.THRESHOLD:
            r = torch.sqrt((rho - 4.0) * (rho - 2.0) * _f32(rho_inf)
                           / (_f32((rho_inf - 4.0) * (rho_inf - 2.0)) * rho))
            denom = torch._foreach_div(vs, float(1 - b2t))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_mul_(update, float(r))
            torch._foreach_div_(update, denom)
        torch._foreach_add_(params, update, alpha=-group["lr"])
        return params

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RAdam.step takes no closure")
        for group in self.param_groups:
            self._update(group)


class Ranger(RAdam):
    """The reference's ``ranger``: Lookahead (Zhang et al. 2019) over
    :class:`RAdam`. The slow weights start as the parameters (taken before
    the first update); after the inner step whose count is a multiple of
    ``SYNC_PERIOD``, ``slow += SLOW_STEP_SIZE·(fast − slow)`` and the
    parameters (the fast weights) are set to ``slow``. Per-parameter state
    adds ``slow``, so a resume from ``state_dict`` continues exactly; the
    count is RAdam's ``step`` (the reference's Lookahead count and its
    inner count are equal)."""

    SYNC_PERIOD, SLOW_STEP_SIZE = 6, 0.5

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Ranger.step takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None and "slow" not in self.state[p]:
                    self.state[p]["slow"] = p.detach().clone()
            params = self._update(group)
            if not params or self._count(
                    [self.state[p] for p in params]) % self.SYNC_PERIOD:
                continue
            slow = [self.state[p]["slow"] for p in params]
            torch._foreach_add_(slow, torch._foreach_sub(params, slow),
                                alpha=self.SLOW_STEP_SIZE)
            torch._foreach_copy_(params, slow)


def build_optimizer(name: str, params: Iterable[torch.nn.Parameter], *,
                    weight_decay: float = 1e-4, momentum: float = 0.9,
                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                    ) -> torch.optim.Optimizer:
    """The reference's ``--optim`` flag: ``sgd``, ``adam``, ``adamw``,
    ``radam`` or ``ranger``."""
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
    if name == "radam":
        return RAdam(params, lr=0.0, betas=(b1, b2), eps=eps,
                     weight_decay=weight_decay)
    if name == "ranger":
        return Ranger(params, lr=0.0, betas=(b1, b2), eps=eps,
                      weight_decay=weight_decay)
    raise KeyError(f"unknown optimizer {name!r}; "
                   "options: sgd adam adamw radam ranger")
