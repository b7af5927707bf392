"""Faults planted under the timed path, for the test that the comparison
catches each fault a cell can have (``perfbench/tests``) and for the
readings that set the limits (``perfbench/tools/readings.py``). Each is
a function of the entry the driver built (``predict`` or the train step)
that returns the broken entry."""
from __future__ import annotations

from typing import Callable, Dict


def answer_altered(predict: Callable) -> Callable:
    """Every map comes back with an 8x8 block of its first image moved to
    the next class."""
    def broken(x):
        y = predict(x).clone()
        classes = 19
        y[0, :8, :8] = (y[0, :8, :8] + 1) % classes
        return y
    return broken


def half_batch_predict(predict: Callable) -> Callable:
    """Only the first half of the batch is predicted; its maps stand in
    for the second half's."""
    import torch

    def broken(x):
        y = predict(x[:x.shape[0] // 2])
        return torch.cat([y, y])
    return broken


def state_unchanged(step):
    """The step computes its loss and gradients and leaves the parameters
    and the optimizer's state as they were."""
    step.optimizer.step = lambda *args, **kwargs: None
    return step


def half_batch_train(step) -> Callable:
    """The step takes the first half of the batch, its loss the mean over
    those images alone."""
    def broken(batch: Dict):
        h = batch["image"].shape[0] // 2
        return step({"image": batch["image"][:h],
                     "label": batch["label"][:h]})
    return broken


BY_ROUTE = {"predict": {"answer_altered": answer_altered,
                        "half_batch": half_batch_predict},
            "train": {"state_unchanged": state_unchanged,
                      "half_batch": half_batch_train}}
