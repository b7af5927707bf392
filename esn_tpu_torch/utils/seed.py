"""Determinism helper (counterpart of ``esn_tpu/utils/seed.py``).

Seeds the host generators the data pipeline may touch (``random``,
numpy, torch's global generator) and returns an explicit
``torch.Generator``. The port's paths draw from explicit generators
(model init, augmentation, dropout), never from a global one.
"""
from __future__ import annotations

import random

import numpy as np
import torch


def setup_seed(seed: int) -> torch.Generator:
    """Seed ``random``, numpy and torch; return a CPU generator seeded
    with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
