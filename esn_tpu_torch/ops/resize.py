"""Spatial resize (counterpart of ``esn_tpu/ops/resize.py``), NCHW.

Half-pixel-centre bilinear (``align_corners=False``) without antialias:
the reference's ``jax.image.resize(..., antialias=False)``, which samples
the plain 2-tap kernel at every scale, as ``F.interpolate`` does.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``size`` = (H, W)."""
    if tuple(size) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False)
