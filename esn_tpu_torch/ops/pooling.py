"""Average pools (counterpart of the avg/adaptive part of
``esn_tpu/ops/pooling.py``), NCHW. Sums are taken in f32 and the result
is cast back to the input dtype, as in the reference."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

IntOr2 = Union[int, Tuple[int, int]]


def avg_pool2d(x: torch.Tensor, window: IntOr2,
               stride: Optional[IntOr2] = None, padding: IntOr2 = 0,
               count_include_pad: bool = True) -> torch.Tensor:
    """Average pool with torch floor semantics."""
    y = F.avg_pool2d(x.float(), window, stride if stride is not None else window,
                     padding, count_include_pad=count_include_pad)
    return y.to(x.dtype)


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    return x.float().mean(dim=(2, 3), keepdim=keepdims).to(x.dtype)


def adaptive_avg_pool2d(x: torch.Tensor, output_size: IntOr2) -> torch.Tensor:
    """torch-style adaptive average pool: bin i of n over a length L spans
    ``[floor(i*L/n), ceil((i+1)*L/n))``, the reference's bin edges."""
    return F.adaptive_avg_pool2d(x.float(), output_size).to(x.dtype)
