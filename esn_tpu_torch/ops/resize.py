"""Spatial resize (counterpart of ``esn_tpu/ops/resize.py``), NCHW.

Half-pixel-centre bilinear (``align_corners=False``) without antialias:
the reference's ``jax.image.resize(..., antialias=False)``, which samples
the plain 2-tap kernel at every scale, as ``F.interpolate`` does. Labels
resize with cv2's ``INTER_NEAREST`` indices (:func:`resize_nearest_cv2`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``size`` = (H, W)."""
    if tuple(size) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False)


def resize_nearest_cv2(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of the last two dims with cv2.INTER_NEAREST's
    indices: destination pixel j reads source ``min(floor(j * src/dst),
    src - 1)``, the product taken in f32 as the reference takes it. Any
    dtype (a gather: integer labels stay integers)."""
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = size
    if (oh, ow) == (h, w):
        return x

    def index(n_out, n_in):
        # the ratio rounded to f32 first, then an f32 product, on the
        # tensor's device (no host copy that would wait on the device)
        ratio = float(np.float32(n_in / n_out))
        i = torch.arange(n_out, dtype=torch.float32, device=x.device) * ratio
        return torch.clamp(i.to(torch.int64), max=n_in - 1)

    return x.index_select(-2, index(oh, h)).index_select(-1, index(ow, w))
