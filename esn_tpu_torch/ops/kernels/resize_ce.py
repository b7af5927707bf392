"""Fused bilinear-upsample + cross-entropy sums (counterpart of
``esn_tpu/ops/pallas/resize_ce.py``).

``(S, N) = (sum_i w_i * nll_i, sum_i w_i)`` over the full-res pixels of
the class-weighted CE of ``upsample_bilinear_xr(z)`` against ``labels``,
with ``ignore_index`` and label smoothing; the loss is ``S / max(N, 1e-8)``.
Differentiable in ``z``; ``N`` does not depend on ``z``.

Public layout is the reference's: z ``(B, h, w, C)`` f32 NHWC, labels
``(B, h*r, w*r)`` int32, class_weights ``(C,)`` f32 or None. On CUDA it is
a ``torch.autograd.Function`` over the forward and backward kernels of
``csrc/resize_ce.cu``, which never hold the full-res logits or their
cotangent (the backward adds per-band slabs from a scratch buffer into
dz); on the CPU the plain :func:`resize_ce_sums_ref`, whose autograd is
the plain backward.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import LAUNCHES, _build

MAX_FACTOR = 16


def resize_ce_sums_ref(z: torch.Tensor, labels: torch.Tensor,
                       class_weights: Optional[torch.Tensor], *, r: int,
                       ignore_index: int = 255, label_smoothing: float = 0.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: f32 upsample to label resolution, then the weighted
    CE sums (``losses._per_pixel_ce`` semantics of the reference); an f64
    z keeps f64."""
    b, h, w, c = z.shape
    wide = torch.promote_types(z.dtype, torch.float32)
    up = F.interpolate(z.permute(0, 3, 1, 2).to(wide), size=(h * r, w * r),
                       mode="bilinear", align_corners=False, antialias=False)
    labels = labels.long()
    valid = (labels != ignore_index) & (labels >= 0) & (labels < c)
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    lse = torch.logsumexp(up, dim=1)
    nll = lse - up.gather(1, safe[:, None]).squeeze(1)
    if label_smoothing > 0.0:
        eps = label_smoothing
        nll = (1.0 - eps) * nll + eps * (lse - up.mean(dim=1))
    wpix = valid.to(wide)
    if class_weights is not None:
        wpix = wpix * class_weights.to(wide)[safe]
    return (wpix * nll).sum(), wpix.sum()


def _check(z, labels, class_weights, r):
    if z.ndim != 4 or labels.ndim != 3:
        raise ValueError(f"resize_ce_sums: z {tuple(z.shape)} must be "
                         f"(B, h, w, C), labels {tuple(labels.shape)} "
                         f"(B, H, W)")
    b, h, w, c = z.shape
    if not 2 <= r <= MAX_FACTOR:
        raise ValueError(f"resize_ce_sums: r={r} not in [2, {MAX_FACTOR}]")
    if tuple(labels.shape) != (b, h * r, w * r):
        raise ValueError(f"resize_ce_sums: labels {tuple(labels.shape)}, "
                         f"want {(b, h * r, w * r)} for z {tuple(z.shape)} "
                         f"and r={r}")
    if class_weights is not None and tuple(class_weights.shape) != (c,):
        raise ValueError(f"resize_ce_sums: class_weights "
                         f"{tuple(class_weights.shape)}, want {(c,)}")
    for name, t in (("labels", labels), ("class_weights", class_weights)):
        if t is not None and t.device != z.device:
            raise ValueError(f"resize_ce_sums: {name} on {t.device}, z on "
                             f"{z.device}")


def _checked_cuda_inputs(z, labels, class_weights):
    """Check what the kernels take; the class weights as f32 (ones for
    None)."""
    if z.dtype != torch.float32:
        raise TypeError(f"resize_ce_sums: z dtype {z.dtype}, want float32")
    if labels.dtype != torch.int32:
        raise TypeError(f"resize_ce_sums: labels dtype {labels.dtype}, "
                        f"want int32")
    if not (z.is_contiguous() and labels.is_contiguous()):
        raise ValueError("resize_ce_sums: z and labels must be contiguous "
                         "(z NHWC)")
    c = z.shape[-1]
    if class_weights is None:
        return torch.ones((c,), dtype=torch.float32, device=z.device)
    return class_weights.to(torch.float32).contiguous()


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


class _ResizeCESums(torch.autograd.Function):
    """The CUDA kernels: forward ``(S, N)``, backward ``dz`` from ``gS``."""

    @staticmethod
    def forward(ctx, z, labels, cw, r, ignore_index, eps):
        b, h, w, c = z.shape
        s = torch.empty((), dtype=torch.float32, device=z.device)
        n = torch.empty((), dtype=torch.float32, device=z.device)
        lib = _build.library()
        doubles = lib.esn_resize_ce_fwd_scratch(b, h, w, c, r)
        if doubles < 0:
            raise ValueError(f"resize_ce_sums: no forward tiling of z "
                             f"{tuple(z.shape)} r={r} fits in shared memory")
        # an (S, N) pair per block, summed in a fixed order by the kernel
        partial = torch.empty((doubles,), dtype=torch.float64,
                              device=z.device)
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.esn_resize_ce_fwd(
            _ptr(z), _ptr(labels), _ptr(cw), _ptr(partial), _ptr(s), _ptr(n),
            b, h, w, c, r, ignore_index, ctypes.c_float(eps),
            ctypes.c_void_p(stream))
        _build.check(err, "resize_ce_sums forward")
        LAUNCHES["resize_ce_fwd"] += 1
        ctx.save_for_backward(z, labels, cw)
        ctx.r, ctx.ignore_index, ctx.eps = r, ignore_index, eps
        ctx.mark_non_differentiable(n)
        return s, n

    @staticmethod
    def backward(ctx, g_s, g_n):
        del g_n                      # N does not depend on z
        z, labels, cw = ctx.saved_tensors
        b, h, w, c = z.shape
        g_s = g_s.to(device=z.device, dtype=torch.float32).contiguous()
        dz = torch.empty_like(z)
        lib = _build.library()
        floats = lib.esn_resize_ce_bwd_scratch(b, h, w, c, ctx.r)
        if floats < 0:
            raise ValueError(f"resize_ce_sums: no backward tiling of z "
                             f"{tuple(z.shape)} r={ctx.r} fits in shared "
                             f"memory")
        # the band slabs that the fold kernel adds into dz
        slabs = torch.empty((floats,), dtype=torch.float32, device=z.device)
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.esn_resize_ce_bwd(
            _ptr(z), _ptr(labels), _ptr(cw), _ptr(g_s), _ptr(slabs), _ptr(dz),
            b, h, w, c, ctx.r, ctx.ignore_index, ctypes.c_float(ctx.eps),
            ctypes.c_void_p(stream))
        _build.check(err, "resize_ce_sums backward")
        LAUNCHES["resize_ce_bwd"] += 1
        return dz, None, None, None, None, None


def resize_ce_sums(z: torch.Tensor, labels: torch.Tensor,
                   class_weights: Optional[torch.Tensor], *, r: int,
                   ignore_index: int = 255, label_smoothing: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(S, N)`` of CE over ``upsample_bilinear_xr(z)``, differentiable in
    z; the CUDA kernels for a CUDA tensor, the plain version on the CPU."""
    r = int(r)
    _check(z, labels, class_weights, r)
    if z.device.type == "cpu":
        return resize_ce_sums_ref(z, labels, class_weights, r=r,
                                  ignore_index=ignore_index,
                                  label_smoothing=label_smoothing)
    if z.device.type != "cuda":
        raise ValueError(f"resize_ce_sums: no kernel for device {z.device}")
    cw = _checked_cuda_inputs(z, labels, class_weights)
    if labels.numel() == 0:
        raise ValueError("resize_ce_sums: empty batch")
    return _ResizeCESums.apply(z, labels, cw, r, int(ignore_index),
                               float(label_smoothing))
