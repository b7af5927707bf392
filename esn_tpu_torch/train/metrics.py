"""mIoU evaluation through a confusion matrix on the tensors' device
(counterpart of ``esn_tpu/train/metrics.py``).

One ``torch.bincount`` over ``gt * K + pred`` per batch, accumulated
into a ``(K, K)`` int64 matrix; the host sees only that matrix. A
drop-in ``get_iou(data_list, class_num)`` host API is kept for the CLIs.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, gt: torch.Tensor, num_classes: int,
                     ignore_index: int = 255) -> torch.Tensor:
    """``(K, K)`` int64 confusion matrix, rows = ground truth, columns =
    prediction, on the tensors' device; any leading shape. Ignored,
    negative and out-of-range labels contribute nothing; predictions are
    clipped to ``[0, K - 1]``."""
    k = num_classes
    pred = pred.reshape(-1).long()
    gt = gt.reshape(-1).long()
    valid = (gt != ignore_index) & (gt >= 0) & (gt < k)
    idx = torch.where(valid, gt * k + pred.clamp(0, k - 1),
                      torch.full_like(gt, k * k))
    return torch.bincount(idx, minlength=k * k + 1)[:k * k].reshape(k, k)


def iou_from_confusion(cm: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class IoU and the mean IoU over the classes with a non-zero
    union, in f64."""
    cm = cm.double()
    tp = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - tp
    iou = tp / torch.clamp(union, min=1e-9)
    present = union > 0
    miou = (torch.where(present, iou, torch.zeros_like(iou)).sum()
            / torch.clamp(present.double().sum(), min=1.0))
    return iou, miou


def pixel_accuracy(cm: torch.Tensor) -> torch.Tensor:
    cm = cm.double()
    return torch.trace(cm) / torch.clamp(cm.sum(), min=1.0)


class MeanIoU:
    """Streaming evaluator: batches accumulate on the device of the first
    update, the result comes to the host."""

    def __init__(self, num_classes: int, ignore_index: int = 255):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.reset()

    def update(self, pred: torch.Tensor, gt: torch.Tensor) -> None:
        cm = confusion_matrix(pred, gt, self.num_classes, self.ignore_index)
        self._cm = cm if self._cm is None else self._cm + cm

    def reset(self) -> None:
        self._cm: Optional[torch.Tensor] = None

    @property
    def matrix(self) -> np.ndarray:
        if self._cm is None:
            return np.zeros((self.num_classes, self.num_classes), np.int64)
        return self._cm.cpu().numpy()

    def result(self) -> Tuple[np.ndarray, float]:
        iou, miou = iou_from_confusion(torch.from_numpy(self.matrix))
        return iou.numpy(), float(miou)


def get_iou(data_list: Sequence[Tuple[np.ndarray, np.ndarray]],
            class_num: int, save_path: Optional[str] = None,
            ignore_index: int = 255) -> Tuple[float, np.ndarray]:
    """List of ``(gt, pred)`` pairs -> (mean IoU, per-class IoU);
    prints the per-class report and, with ``save_path``, writes it."""
    evaluator = MeanIoU(class_num, ignore_index)
    for gt, pred in data_list:
        evaluator.update(torch.as_tensor(np.asarray(pred)),
                         torch.as_tensor(np.asarray(gt)))
    iou, miou = evaluator.result()
    lines = [f"class {i:2d}: IoU {v:.4f}" for i, v in enumerate(iou)]
    lines.append(f"meanIoU: {miou:.4f}")
    report = "\n".join(lines)
    print(report)
    if save_path:
        with open(save_path, "w") as f:
            f.write(report + "\n")
    return miou, iou
