"""Segmentation losses (counterpart of ``esn_tpu/train/losses.py``).

All take NHWC logits and ``(N, H, W)`` integer labels, reduce in f32, and
follow torch's reduction for class-weighted CE with ``ignore_index``:
``sum(w[y_i] * ce_i) / sum(w[y_i])`` over valid pixels (label not
``ignore_index`` and in ``[0, C)``).

``resize_cross_entropy`` is CE over the bilinear upsample of low-res
logits to label resolution. For an integer isotropic scale it goes to the
fused kernel ``ops.kernels.resize_ce_sums`` (the plain version on the
CPU), so the full-res logits never exist on the card. In the port a
CE-family loss on a resize-tail model always owns the upsample
(:func:`fused_resize_ce_spec`); the reference keeps that route behind an
environment switch and TPU-only gates, which have no counterpart here.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import torch

from ..ops import kernels as K
from ..ops.resize import resize_bilinear


def _per_pixel_ce(logits: torch.Tensor, labels: torch.Tensor,
                  num_classes: int, ignore_index: int,
                  label_smoothing: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(nll per pixel f32, labels safe for lookup, valid mask)."""
    x = logits.float()
    labels = labels.long()
    valid = (labels != ignore_index) & (labels >= 0) & (labels < num_classes)
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    lse = torch.logsumexp(x, dim=-1)
    nll = lse - x.gather(-1, safe[..., None]).squeeze(-1)
    if label_smoothing > 0.0:
        eps = label_smoothing
        nll = (1.0 - eps) * nll + eps * (lse - x.mean(dim=-1))
    return nll, safe, valid


def _pixel_weights(class_weights: Optional[torch.Tensor], safe: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    w = mask.float()
    if class_weights is not None:
        w = w * class_weights.float()[safe]
    return w


def cross_entropy(logits, labels, *, num_classes: int,
                  class_weights: Optional[torch.Tensor] = None,
                  ignore_index: int = 255,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Class-weighted CE with ignore_index, torch reduction semantics."""
    nll, safe, valid = _per_pixel_ce(logits, labels, num_classes,
                                     ignore_index, label_smoothing)
    w = _pixel_weights(class_weights, safe, valid)
    return (w * nll).sum() / torch.clamp(w.sum(), min=1e-8)


def resize_cross_entropy(z, labels, *, num_classes: int,
                         class_weights: Optional[torch.Tensor] = None,
                         ignore_index: int = 255,
                         label_smoothing: float = 0.0) -> torch.Tensor:
    """CE(bilinear_upsample(z), labels) for low-res NHWC logits z.

    An integer isotropic scale 2 <= r <= 16 runs the fused kernel (z f32
    contiguous NHWC, labels int32 on the card); any other scale
    upsamples in f32 and takes :func:`cross_entropy`, as the reference's
    materialized path does.
    """
    b, h, w, c = z.shape
    hl, wl = labels.shape[1], labels.shape[2]
    r = hl // h
    if (hl % h or wl % w or r != wl // w
            or not 2 <= r <= K.resize_ce.MAX_FACTOR):
        full = resize_bilinear(z.float().permute(0, 3, 1, 2), (hl, wl))
        return cross_entropy(full.permute(0, 2, 3, 1), labels,
                             num_classes=num_classes,
                             class_weights=class_weights,
                             ignore_index=ignore_index,
                             label_smoothing=label_smoothing)
    s, n = K.resize_ce_sums(z.float(), labels, class_weights, r=r,
                            ignore_index=ignore_index,
                            label_smoothing=label_smoothing)
    return s / torch.clamp(n, min=1e-8)


def ohem_kept_mask(nll: torch.Tensor, valid: torch.Tensor, thresh: float,
                   min_kept: int) -> torch.Tensor:
    """OHEM's kept pixels, flat: true-class probability at or below
    ``max(thresh, the min_kept-th smallest probability)``; ignored pixels
    count as probability 2 and are never kept."""
    p_true = torch.where(valid, torch.exp(-nll), torch.full_like(nll, 2.0))
    p_true = p_true.reshape(-1)
    # the min_kept-th smallest as the largest of the min_kept smallest:
    # torch.kthvalue selects within one slice by a single block on CUDA
    # (121 ms for the 16.7 M probabilities of a batch of 8 at 1024x2048 on
    # an H100, where this topk stays under 1 ms; the same value)
    kth = torch.topk(p_true, min_kept, largest=False,
                     sorted=False).values.max()
    threshold = torch.clamp(kth, min=thresh)
    return (p_true <= threshold) & valid.reshape(-1)


def ohem_cross_entropy(logits, labels, *, num_classes: int,
                       class_weights: Optional[torch.Tensor] = None,
                       ignore_index: int = 255, thresh: float = 0.7,
                       min_kept: Optional[int] = None) -> torch.Tensor:
    """Online hard example mining CE (reference ProbOhemCrossEntropy2d):
    CE over the kept pixels of :func:`ohem_kept_mask`, at least
    ``min_kept`` (default ``B*H*W // 16``) of them."""
    n, h, w, _ = logits.shape
    total = n * h * w
    if min_kept is None:
        min_kept = max(total // 16, 1)
    min_kept = int(min(min_kept, total))
    nll, safe, valid = _per_pixel_ce(logits, labels, num_classes,
                                     ignore_index)
    kept = ohem_kept_mask(nll.detach(), valid, thresh, min_kept)
    wpix = _pixel_weights(class_weights, safe.reshape(-1), kept)
    return (wpix * nll.reshape(-1)).sum() / torch.clamp(wpix.sum(), min=1e-8)


LOSS_REGISTRY = {
    "ce": cross_entropy,
    "label_smoothing": partial(cross_entropy, label_smoothing=0.1),
    "ohem": ohem_cross_entropy,
}


def build_loss(name: str, **defaults) -> Callable:
    """The reference's loss selection: weighted CE by default."""
    if name not in LOSS_REGISTRY:
        raise KeyError(f"unknown loss {name!r}; options: "
                       f"{sorted(LOSS_REGISTRY)}")
    fn = LOSS_REGISTRY[name]
    return partial(fn, **defaults) if defaults else fn


def fused_resize_ce_spec(model, loss_name: str):
    """``(loss_builder, fwd_method)`` for a CE-family loss on a resize-tail
    model (``LOGITS_TAIL == "resize"`` with ``logits_lowres``): the loss
    owns the upsample, through the fused kernel. ``(None, None)`` for any
    other pair."""
    if (loss_name in ("ce", "label_smoothing")
            and getattr(model, "LOGITS_TAIL", "conv") == "resize"
            and hasattr(model, "logits_lowres")):
        smooth = 0.1 if loss_name == "label_smoothing" else 0.0
        return (partial(resize_cross_entropy, label_smoothing=smooth),
                "logits_lowres")
    return None, None
