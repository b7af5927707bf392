"""Spatial resize (counterpart of ``esn_tpu/ops/resize.py``), NCHW.

Half-pixel-centre bilinear (``align_corners=False``) without antialias:
the reference's ``jax.image.resize(..., antialias=False)``, which samples
the plain 2-tap kernel at every scale, as ``F.interpolate`` does. Labels
resize with cv2's ``INTER_NEAREST`` indices (:func:`resize_nearest_cv2`).

Under spatial sharding (``parallel.spatial``) ``size`` is this rank's
share: ``S`` shards of ``size[0]`` rows. A sharded input (``sharded``)
fetches the source rows its output rows read beyond its own, resizes
that window with ``F.interpolate`` by the global ratio and keeps its
rows: the window starts on a row whose half-pixel grid is the global one
shifted by whole rows, so every output is computed as on the whole
tensor, bit for bit. The backward fetches the output gradient rows that
read this rank's input rows and resizes back over its own window, so
each input row's gradient sums the same terms in the same order as on
the whole tensor. A replicated input (inside ``spatial.replicated``,
PPM's pooled maps) needs no exchange: the whole resize, this rank's
rows of it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import spatial


def _interpolate(x: torch.Tensor, ratio: float, w_out: int) -> torch.Tensor:
    """``x`` resized by ``ratio`` along H (``x``'s own half-pixel grid)
    and to ``w_out`` columns: torch takes the scales as ``1 / ratio``,
    ``W / w_out``, which for the power-of-two ratios of the models are
    what ``size`` gives on the whole tensor."""
    y = F.interpolate(x, scale_factor=(ratio, w_out / x.shape[3]),
                      mode="bilinear", align_corners=False, antialias=False,
                      recompute_scale_factor=False)
    if y.shape[3] != w_out:
        raise ValueError(f"spatial: a resize of {x.shape[3]} columns to "
                         f"{w_out} is not a whole scale factor")
    return y


class _ShardedResize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size, ax):
        rows = spatial.resize_rows(x.shape[2], size[0], ax.size, ax.index)
        ctx.rows, ctx.ax, ctx.size, ctx.shape = rows, ax, size, x.shape
        win = spatial.gather_window(x, rows.windows, ax)
        return _interpolate(win, rows.ratio, size[1]).narrow(
            2, rows.start, size[0])

    @staticmethod
    def backward(ctx, g):
        rows, ax = ctx.rows, ctx.ax
        n, c, h, w = ctx.shape
        g = spatial.gather_window(g, rows.grad_windows, ax)
        lo, hi = rows.grad_in
        with torch.enable_grad():
            t = spatial._like(g.new_zeros((n, c, hi - lo, w)), g) \
                .requires_grad_()
            y = _interpolate(t, rows.ratio, ctx.size[1]).narrow(
                2, rows.grad_start, g.shape[2])
            gx, = torch.autograd.grad(y, t, g)
        return gx.narrow(2, rows.own, h), None, None


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``size`` = (H, W)."""
    rep = spatial.replicated_axis()
    if rep is not None:
        full = F.interpolate(x, size=(size[0] * rep.size, size[1]),
                             mode="bilinear", align_corners=False,
                             antialias=False)
        return full.narrow(2, rep.index * size[0], size[0])
    if tuple(size) == tuple(x.shape[2:]):
        return x
    ax = spatial.axis()
    if ax is not None:
        return _ShardedResize.apply(x, tuple(size), ax)
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
