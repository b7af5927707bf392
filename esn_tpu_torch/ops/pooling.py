"""Pools (counterpart of ``esn_tpu/ops/pooling.py``), NCHW.

Average pools take their sums in f32 and cast the result back to the
input dtype, as in the reference.

The index-preserving 2x2 max pool and its unpool are
``F.max_pool2d(return_indices=True)`` and ``F.max_unpool2d``. The
reference's one-hot formulation stands in for a scatter its device
lacks; its indices are window positions in [0, 4). Here an index is
torch's: the flat offset ``row * 2w + col`` of the chosen element in the
``(2h, 2w)`` plane that the pool read (the input less an odd trailing row
and column). The semantics are the reference's: ties go to the first
window position in the order (0,0), (0,1), (1,0), (1,1); the unpool's
gradient is the gather; the pool's gradient reaches only the remembered
position (at a tie the reference's ``jnp.max`` splits it evenly among
the tied elements, with the same sum a window: the two agree wherever
nothing ties)."""
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


def max_pool2d(x: torch.Tensor, window: IntOr2,
               stride: Optional[IntOr2] = None,
               padding: IntOr2 = 0) -> torch.Tensor:
    """Standard max pool with torch floor semantics."""
    return F.max_pool2d(x, window, stride if stride is not None else window,
                        padding)


def max_pool2d_with_indices_2x2(x: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2 stride-2 max pool returning ``(values, indices)``, both
    ``(N, C, H//2, W//2)``; indices int64 (see the module docstring). Odd
    trailing rows and columns are dropped."""
    h2, w2 = x.shape[2] // 2, x.shape[3] // 2
    return F.max_pool2d(x[:, :, :2 * h2, :2 * w2], 2, 2, return_indices=True)


def max_unpool2d_2x2(y: torch.Tensor, idx: torch.Tensor,
                     output_size: Optional[Tuple[int, int]] = None
                     ) -> torch.Tensor:
    """Inverse of :func:`max_pool2d_with_indices_2x2`: each value at its
    remembered position of a ``(2h, 2w)`` plane, zeros elsewhere, in y's
    memory format. ``output_size`` (H, W) pads with zeros or crops, for
    odd originals."""
    h, w = y.shape[2], y.shape[3]
    out = F.max_unpool2d(y, idx, 2, 2, output_size=(2 * h, 2 * w))
    if output_size is not None:
        oh, ow = output_size
        if oh > 2 * h or ow > 2 * w:
            out = F.pad(out, (0, max(0, ow - 2 * w), 0, max(0, oh - 2 * h)))
        out = out[:, :, :oh, :ow]
    if (y.is_contiguous(memory_format=torch.channels_last)
            and not y.is_contiguous()):
        out = out.contiguous(memory_format=torch.channels_last)
    return out
