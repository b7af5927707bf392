"""Spatial resize (counterpart of ``esn_tpu/ops/resize.py``), NCHW.

Half-pixel-centre bilinear (``align_corners=False``) without antialias:
the reference's ``jax.image.resize(..., antialias=False)``, which samples
the plain 2-tap kernel at every scale, as ``F.interpolate`` does. Labels
resize with cv2's ``INTER_NEAREST`` indices (:func:`resize_nearest_cv2`).

Under spatial sharding (``parallel.spatial``) ``size`` is this rank's
share: the ranks' ``size[0]`` sum to the output's rows, which split as
every tensor does (``spatial.bounds``). A sharded input (``sharded``)
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

Every resize here is ``F.interpolate``; where a CUDA tensor's gradient is
recorded it goes through ``kernels.BilinearResize``, whose backward is
the kernel K5 (torch's CUDA backward adds with atomics in no fixed
order), the sharded backward's resize included.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import spatial
from . import kernels as K


def _bilinear(x: torch.Tensor, size=None, scale_factor=None) -> torch.Tensor:
    """``F.interpolate`` (bilinear, half-pixel, no antialias) to ``size``
    or by ``scale_factor`` (not recomputed); through K5's autograd route
    where ``kernels.kernel_backward`` says so."""
    if K.kernel_backward(x):
        return K.BilinearResize.apply(x, size, scale_factor)
    return F.interpolate(x, size=size, scale_factor=scale_factor,
                         mode="bilinear", align_corners=False,
                         antialias=False,
                         recompute_scale_factor=False
                         if scale_factor is not None else None)


def _interpolate(x: torch.Tensor, ratio: float, w_out: int) -> torch.Tensor:
    """``x`` resized by ``ratio`` along H (``x``'s own half-pixel grid)
    and to ``w_out`` columns: torch takes the scales as ``1 / ratio``,
    ``W / w_out``, which for the power-of-two ratios of the models are
    what ``size`` gives on the whole tensor."""
    y = _bilinear(x, scale_factor=(ratio, w_out / x.shape[3]))
    if y.shape[3] != w_out:
        raise ValueError(f"spatial: a resize of {x.shape[3]} columns to "
                         f"{w_out} is not a whole scale factor")
    return y


class _ShardedResize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows, w_out, ax):
        ctx.rows, ctx.ax, ctx.w_out, ctx.shape = rows, ax, w_out, x.shape
        win = spatial.gather_window(x, rows.windows, ax, rows.total_in)
        return _interpolate(win, rows.ratio, w_out).narrow(
            2, rows.start, rows.rows)

    @staticmethod
    def backward(ctx, g):
        rows, ax = ctx.rows, ctx.ax
        n, c, h, w = ctx.shape
        g = spatial.gather_window(g, rows.grad_windows, ax, rows.total_out)
        lo, hi = rows.grad_in
        if lo == hi:
            # no output row reads these rows; the exchange was joined
            return g.new_zeros((n, c, h, w)), None, None, None
        with torch.enable_grad():
            t = spatial._like(g.new_zeros((n, c, hi - lo, w)), g) \
                .requires_grad_()
            y = _interpolate(t, rows.ratio, ctx.w_out).narrow(
                2, rows.grad_start, g.shape[2])
            gx, = torch.autograd.grad(y, t, g)
        return gx.narrow(2, rows.own, h), None, None, None


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``size`` = (H, W). Under
    spatial sharding ``size[0]`` is this rank's share of the output rows:
    the output's global rows are the ranks' shares summed, and this rank
    gets its shard of them (:func:`spatial.bounds`), which is its share
    wherever the shares are the balanced split."""
    rep = spatial.replicated_axis()
    if rep is not None:
        total = spatial.global_rows(rep, size[0])[0]
        lo, hi = spatial.my_rows(total, rep)
        full = _bilinear(x, size=(total, size[1]))
        return full.narrow(2, lo, hi - lo)
    ax = spatial.axis()
    if ax is not None:
        t_in, t_out = spatial.global_rows(ax, x.shape[2], size[0])
        if (t_in, size[1]) == (t_out, x.shape[3]):
            return x
        rows = spatial.resize_rows(t_in, t_out, ax.size, ax.index)
        return _ShardedResize.apply(x, rows, size[1], ax)
    if tuple(size) == tuple(x.shape[2:]):
        return x
    return _bilinear(x, size=tuple(size))


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
