"""Evaluation loop (counterpart of ``esn_tpu/train/evaluation.py``).

Every eval batch is padded on the host to one fixed shape, so cuDNN picks
its algorithms once per resolution and the last, shorter batch of a split
runs like the others; padded rows are masked out of the confusion matrix
through the batch's ``valid`` count (``train.step.make_eval_step``).

Under a data-parallel group (``parallel.mesh``), as under the reference's
``mesh`` argument, the fixed batch is rounded up to a multiple of the
world's ranks, each rank evaluates its rows of it, masks its rows past
the batch's real count, and the confusion matrices are summed over the
ranks. Under spatial sharding too: the reference evaluates on its data
axis with whole, replicated images on the model axis; here eval runs
outside ``spatial.sharded()``, each of the ``W`` ranks on whole images
of its own, which gives the same confusion matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..parallel import mesh
from ..parallel.mesh import pad_batch_to, pad_batch_to_devices  # noqa: F401


def eval_batch_size(loader_batch: int, ranks: int = 1) -> int:
    """The fixed eval batch: the loader's batch size rounded up to a
    multiple of the ranks."""
    return -(-int(loader_batch) // ranks) * ranks


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
      row (numpy); padded rows are never surfaced. Under a group it runs
      on rank 0, on every real row (the predictions are gathered).

    Under a data-parallel group every rank reads the whole batch and
    evaluates its rows of it; the matrix returned is the global one on
    every rank.
    """
    device = eval_step.device
    # every rank on rows of its own, whatever the (data, model) layout
    w = dataclasses.replace(mesh.world(), spatial=1)
    target_b = getattr(loader, "batch_size", None)
    cm = np.zeros((num_classes, num_classes), np.int64)
    for batch in loader:
        if "label" not in batch:
            continue        # an unlabeled split: nothing to score
        arrays = {"image": np.asarray(batch["image"]),
                  "label": np.asarray(batch["label"])}
        if not target_b:
            target_b = arrays["image"].shape[0]
        padded, real = pad_batch_to(arrays, eval_batch_size(target_b,
                                                            w.size))
        rows = padded["image"].shape[0] // w.size
        mine = mesh.shard_batch(padded, w=w)
        images = eval_transform(torch.from_numpy(mine["image"]).to(device))
        pred, cm_b = eval_step({
            "image": images,
            "label": torch.from_numpy(mine["label"]).to(device),
            "valid": min(max(real - w.rank * rows, 0), rows)})
        cm += cm_b.cpu().numpy()
        if per_image is not None:
            pred = mesh.gather_rows(pred)
            if w.rank == 0:
                pred_np = pred[:real].cpu().numpy()
                for i in range(real):
                    per_image(i, pred_np[i], batch)
    return cm
