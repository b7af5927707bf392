"""Parameter utilities (counterpart of ``esn_tpu/utils/params.py``)."""
from __future__ import annotations

from torch import nn


def count_params(model: nn.Module) -> int:
    """Trainable parameter count (BN running stats excluded), as the
    reference counts its ``params`` collection."""
    return sum(p.numel() for p in model.parameters())
