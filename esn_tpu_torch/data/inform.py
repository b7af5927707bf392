"""Dataset statistics ("inform") pass: per-channel mean/std and class
weights (counterpart of ``esn_tpu/data/inform.py``, the same arithmetic).

One pass over the train split accumulates the per-channel mean and a
per-class pixel histogram, then

    w_c = 1 / ln(normVal + p_c),   normVal = 1.10,  p_c = hist_c / sum(hist)

cached as a pickle at ``{root}/inform/{dataset}_inform.pkl`` with the
reference's keys ('classWeights', 'mean', 'std'), so a cache written by
either package serves both.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Iterable, Optional, Tuple

import numpy as np


def compute_class_weights(histogram: np.ndarray,
                          norm_val: float = 1.10) -> np.ndarray:
    hist = histogram.astype(np.float64)
    p = hist / max(hist.sum(), 1.0)
    return (1.0 / np.log(norm_val + p)).astype(np.float32)


def collect_stats(samples: Iterable[Tuple[np.ndarray, np.ndarray]],
                  num_classes: int, ignore_label: int,
                  norm_val: float = 1.10) -> Dict[str, np.ndarray]:
    """samples yields (image HWC uint8/float BGR, label HW int).

    Returns {'classWeights','mean','std'} (reference key names [R]).
    Label values outside [0, num_classes) other than ignore_label raise —
    the reference's data-integrity assertion (SURVEY.md §4).
    """
    hist = np.zeros(num_classes, np.int64)
    mean = np.zeros(3, np.float64)
    m2 = np.zeros(3, np.float64)
    count = 0
    n_px = 0
    for image, label in samples:
        lab = np.asarray(label)
        bad = (lab >= num_classes) & (lab != ignore_label)
        if bad.any():
            raise ValueError(
                f"label values {np.unique(lab[bad])} outside "
                f"[0,{num_classes}) and != ignore {ignore_label}")
        hist += np.bincount(lab[lab != ignore_label].reshape(-1),
                            minlength=num_classes)[:num_classes]
        img = np.asarray(image, np.float64)
        mean += img.reshape(-1, 3).sum(0)
        m2 += (img.reshape(-1, 3) ** 2).sum(0)
        n_px += img.shape[0] * img.shape[1]
        count += 1
    if count == 0:
        raise ValueError("no samples")
    mu = mean / n_px
    var = m2 / n_px - mu ** 2
    return {
        "classWeights": compute_class_weights(hist, norm_val),
        "mean": mu.astype(np.float32),
        "std": np.sqrt(np.maximum(var, 0)).astype(np.float32),
    }


def load_or_compute_inform(cache_path: Optional[str], samples_fn,
                           num_classes: int, ignore_label: int,
                           norm_val: float = 1.10) -> Dict[str, np.ndarray]:
    """Pickle-cached stats (reference inform pkl contract [R])."""
    if cache_path and os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            return pickle.load(f)
    stats = collect_stats(samples_fn(), num_classes, ignore_label, norm_val)
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        with open(cache_path, "wb") as f:
            pickle.dump(stats, f)
    return stats
