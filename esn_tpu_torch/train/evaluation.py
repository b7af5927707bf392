"""Evaluation loop for one device (counterpart of
``esn_tpu/train/evaluation.py``).

Every eval batch is padded on the host to one fixed shape, so cuDNN picks
its algorithms once per resolution and the last, shorter batch of a split
runs like the others; padded rows are masked out of the confusion matrix
through the batch's ``valid`` count (``train.step.make_eval_step``). The
reference's ``mesh`` argument (batches sharded over several devices) has
no counterpart yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch


def eval_batch_size(loader_batch: int) -> int:
    """The fixed eval batch: the loader's batch size on one device."""
    return int(loader_batch)


def pad_batch_to(batch: Dict[str, np.ndarray], target_b: int
                 ) -> Tuple[Dict[str, np.ndarray], int]:
    """Pad every array's leading dim up to ``target_b`` (numpy, edge
    mode); other values pass through. Returns (padded batch, real
    count)."""
    def pad(x):
        if not isinstance(x, np.ndarray) or x.shape[0] == target_b:
            return x
        if x.shape[0] > target_b:
            raise ValueError(f"batch {x.shape[0]} exceeds pad target "
                             f"{target_b}")
        width = [(0, target_b - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, width, mode="edge")
    real = next(v for v in batch.values()
                if isinstance(v, np.ndarray)).shape[0]
    return {k: pad(v) for k, v in batch.items()}, real


def run_eval(eval_step: Callable, loader: Iterable, eval_transform: Callable,
             num_classes: int, *,
             per_image: Optional[Callable] = None) -> np.ndarray:
    """Accumulate the ``(K, K)`` int64 confusion matrix over ``loader``,
    any iterable of ``{"image", "label"}`` numpy batches (its
    ``batch_size`` attribute, else the first batch's size, is the fixed
    eval batch).

    - ``eval_step`` from ``train.step.make_eval_step`` (it masks the rows
      past ``valid``); the images go to its ``device``.
    - ``eval_transform(images)``: the loader's images, as a tensor on that
      device, to the model's ``(N, C, H, W)`` float input.
    - ``per_image(i, pred_hw, batch)``: optional callback on each real
      row (numpy); padded rows are never surfaced.
    """
    device = eval_step.device
    target_b = getattr(loader, "batch_size", None)
    cm = np.zeros((num_classes, num_classes), np.int64)
    for batch in loader:
        if "label" not in batch:
            continue        # an unlabeled split: nothing to score
        arrays = {"image": np.asarray(batch["image"]),
                  "label": np.asarray(batch["label"])}
        if not target_b:
            target_b = arrays["image"].shape[0]
        padded, real = pad_batch_to(arrays, eval_batch_size(target_b))
        images = eval_transform(torch.from_numpy(padded["image"]).to(device))
        pred, cm_b = eval_step({
            "image": images,
            "label": torch.from_numpy(padded["label"]).to(device),
            "valid": real})
        cm += cm_b.cpu().numpy()
        if per_image is not None:
            pred_np = pred[:real].cpu().numpy()
            for i in range(real):
                per_image(i, pred_np[i], batch)
    return cm
