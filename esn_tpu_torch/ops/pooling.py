"""Pools (counterpart of ``esn_tpu/ops/pooling.py``), NCHW.

Average pools take their sums in f32 (f64 for an f64 input) and cast the
result back to the input dtype, as in the reference.

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
nothing ties).

Under spatial sharding (``parallel.spatial.sharded``) the window pools
fetch the rows their windows read from the model group and pool with no
H padding: max pools see -inf, average pools zeros at the global border
only (``count_include_pad`` counts padded rows there alone). The global
pool sums each rank's rows over the group: its result is replicated on
it. The adaptive pool takes whole maps only (it raises on a shard). The 2x2 index pool and its unpool stay local: inside
the envelope every shard starts on an even row, so a window never
crosses two shards (asserted), and an index only needs to be read back
by the same rank's unpool."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..parallel import spatial

IntOr2 = Union[int, Tuple[int, int]]


def _pair(v: IntOr2) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _halo(x: torch.Tensor, ax, window: IntOr2, stride: IntOr2,
          padding: IntOr2, fill: float):
    """(this rank's window of rows, the W padding, the windows)."""
    (kh, _), (sh, _), (ph, pw) = _pair(window), _pair(stride), _pair(padding)
    windows, _ = spatial.stencil_windows(x.shape[2], ax, kh, sh, ph)
    return spatial.fetch_window(x, windows, ax, fill), (0, pw), windows


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or in f64 if it is f64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def avg_pool2d(x: torch.Tensor, window: IntOr2,
               stride: Optional[IntOr2] = None, padding: IntOr2 = 0,
               count_include_pad: bool = True) -> torch.Tensor:
    """Average pool with torch floor semantics."""
    stride = stride if stride is not None else window
    ax = spatial.axis()
    if ax is None:
        y = F.avg_pool2d(_wide(x), window, stride, padding,
                         count_include_pad=count_include_pad)
        return y.to(x.dtype)
    win, pad, windows = _halo(_wide(x), ax, window, stride, padding, 0.0)
    y = F.avg_pool2d(win, window, stride, pad,
                     count_include_pad=count_include_pad)
    kh, total = _pair(window)[0], x.shape[2] * ax.size
    if not count_include_pad and _pair(padding)[0]:
        # the H count of each window: its rows inside [0, H)
        lo, _ = windows[ax.index]
        starts = lo + _pair(stride)[0] * torch.arange(y.shape[2])
        rows = (torch.clamp(starts + kh, max=total)
                - torch.clamp(starts, min=0)).to(y.dtype)
        y = y * (kh / rows).to(y.device)[:, None]
    return y.to(x.dtype)


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    ax = spatial.axis()
    if ax is None:
        return _wide(x).mean(dim=(2, 3), keepdim=keepdims).to(x.dtype)
    s = spatial.group_sum(_wide(x).sum(dim=(2, 3), keepdim=keepdims), ax)
    return (s / (x.shape[2] * ax.size * x.shape[3])).to(x.dtype)


def adaptive_avg_pool2d(x: torch.Tensor, output_size: IntOr2) -> torch.Tensor:
    """torch-style adaptive average pool: bin i of n over a length L spans
    ``[floor(i*L/n), ceil((i+1)*L/n))``, the reference's bin edges.

    A shard raises: pool the whole map (``spatial.whole``) inside
    ``spatial.replicated()``, as PPM does."""
    if spatial.axis() is not None:
        raise ValueError(
            "adaptive_avg_pool2d: a shard's rows; pool spatial.whole(x) "
            "inside spatial.replicated() (the result is replicated)")
    return F.adaptive_avg_pool2d(_wide(x), output_size).to(x.dtype)


def max_pool2d(x: torch.Tensor, window: IntOr2,
               stride: Optional[IntOr2] = None,
               padding: IntOr2 = 0) -> torch.Tensor:
    """Standard max pool with torch floor semantics."""
    stride = stride if stride is not None else window
    ax = spatial.axis()
    if ax is None:
        return F.max_pool2d(x, window, stride, padding)
    win, pad, _ = _halo(x, ax, window, stride, padding, float("-inf"))
    return F.max_pool2d(win, window, stride, pad)


def max_pool2d_with_indices_2x2(x: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2 stride-2 max pool returning ``(values, indices)``, both
    ``(N, C, H//2, W//2)``; indices int64 (see the module docstring). Odd
    trailing rows and columns are dropped. Local under spatial sharding
    (see the module docstring): a shard of odd rows raises."""
    if spatial.axis() is not None and x.shape[2] % 2:
        raise ValueError(f"spatial: a 2x2 index pool over shards of "
                         f"{x.shape[2]} rows would cross shards; the "
                         f"envelope keeps shards even")
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
