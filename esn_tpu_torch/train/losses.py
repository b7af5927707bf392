"""Segmentation losses (counterpart of ``esn_tpu/train/losses.py``).

All take NHWC logits and ``(N, H, W)`` integer labels, reduce in f32, and
follow torch's reduction for class-weighted CE with ``ignore_index``:
``sum(w[y_i] * ce_i) / sum(w[y_i])`` over valid pixels (label not
``ignore_index`` and in ``[0, C)``). The Lovász losses
(:func:`lovasz_softmax`, by sorting, and :func:`lovasz_softmax_hist`, by
counting) take the mean over the classes present instead and ignore
class weights, as the reference's.

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


def focal_loss(logits, labels, *, num_classes: int,
               class_weights: Optional[torch.Tensor] = None,
               ignore_index: int = 255, gamma: float = 2.0) -> torch.Tensor:
    """Focal loss (the reference's FocalLoss2d, gamma 2): ``(1 -
    p_y)^gamma * ce`` per pixel, reduced as :func:`cross_entropy`; gamma 0
    is :func:`cross_entropy`."""
    nll, safe, valid = _per_pixel_ce(logits, labels, num_classes,
                                     ignore_index)
    focal = torch.pow(1.0 - torch.exp(-nll), gamma) * nll
    w = _pixel_weights(class_weights, safe, valid)
    return (w * focal).sum() / torch.clamp(w.sum(), min=1e-8)


def _lovasz_errors(logits, labels, num_classes: int, ignore_index: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(errors, fg, valid)`` of every pixel and class, flat ``(N, C)``:
    ``fg`` the one-hot of valid labels (f32), ``errors = |fg - softmax|``,
    0 at ignored pixels (they sort last and add nothing)."""
    probs = torch.softmax(logits.float(), dim=-1).reshape(-1, num_classes)
    labels = labels.reshape(-1).long()
    valid = (labels != ignore_index) & (labels >= 0) & (labels < num_classes)
    classes = torch.arange(num_classes, device=labels.device)
    fg = ((labels[:, None] == classes) & valid[:, None]).float()
    errors = (fg - probs).abs() * valid[:, None]
    return errors, fg, valid


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension of the Jaccard loss with respect to
    errors sorted in descending order, along the last axis (f32 0/1
    ``gt_sorted``). The counts are integers, exact in f32 up to 2^24
    pixels a class."""
    gts = gt_sorted.sum(-1, keepdim=True)
    cum_fg = gt_sorted.cumsum(-1)
    seen = torch.arange(1, gt_sorted.shape[-1] + 1, device=gt_sorted.device,
                        dtype=gt_sorted.dtype)
    intersection = gts - cum_fg
    union = gts + (seen - cum_fg)
    jaccard = 1.0 - intersection / torch.clamp(union, min=1e-8)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]],
                     dim=-1)


def _present_mean(per_class: torch.Tensor, present: torch.Tensor
                  ) -> torch.Tensor:
    """The mean over present classes (``classes='present'``); 0 when none
    is."""
    present = present.float()
    return (per_class * present).sum() / torch.clamp(present.sum(), min=1e-8)


def lovasz_softmax(logits, labels, *, num_classes: int,
                   ignore_index: int = 255,
                   class_weights: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Multi-class Lovász-Softmax over the present classes (the reference's
    LovaszSoftmax, ``per_image=False``, ``classes='present'``).
    ``class_weights`` is accepted and unused, as in the reference.

    One stable descending sort of every class's errors at once (a
    ``(C, N)`` sort); ties keep pixel order, as the reference's stable
    ``lax.sort`` of the negated errors does, so each pixel's gradient is
    the reference's. The sort and the Lovász gradient carry no gradient
    (the extension is piecewise linear in the errors): the loss is
    ``Σ errors · g`` with ``g`` the sorted gradient put back at each
    pixel, which has the reference's value (summed in another order) and
    its gradient.
    """
    del class_weights
    errors, fg, _ = _lovasz_errors(logits, labels, num_classes, ignore_index)
    with torch.no_grad():
        coef = _lovasz_sort_coefficients(errors, fg)
    return _present_mean((errors * coef).sum(0), fg.sum(0) > 0)


def _lovasz_sort_coefficients(errors: torch.Tensor, fg: torch.Tensor
                              ) -> torch.Tensor:
    """Each pixel and class's Lovász gradient of :func:`lovasz_softmax`,
    flat ``(N, C)`` like ``errors`` and ``fg``, without gradient: one
    stable descending sort of every class's errors at once."""
    errors, fg = errors.t(), fg.t().contiguous()
    perm = torch.sort(errors, dim=-1, descending=True, stable=True)[1]
    return torch.empty_like(fg).scatter_(
        -1, perm, _lovasz_grad(fg.gather(-1, perm))).t()


def _lovasz_hist_coefficients(errors: torch.Tensor, fg: torch.Tensor,
                              valid: torch.Tensor, n_buckets: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the coefficient of each pixel and class, flat ``(N, C)`` f32; the
    classes present) of :func:`lovasz_softmax_hist`, without gradient:
    ΔJaccard / count of the pixel's key, 0 for absent classes."""
    c, nb = errors.shape[1], n_buckets
    key = (errors.detach() * (nb - 1)).to(torch.int32).clamp_(0, nb - 1)
    key += torch.arange(c, device=key.device, dtype=torch.int32) * nb
    spare = torch.tensor(c * nb, device=key.device, dtype=torch.int32)
    n_b = torch.bincount(torch.where(valid[:, None], key, spare).flatten(),
                         minlength=c * nb + 1)
    fg_b = torch.bincount(torch.where(fg.bool(), key, spare).flatten(),
                          minlength=c * nb + 1)
    # descending keys (largest errors first), per class
    n_b = n_b[:c * nb].view(c, nb).flip(-1)
    fg_b = fg_b[:c * nb].view(c, nb).flip(-1)
    gts = fg_b.sum(-1, keepdim=True)
    cum_n, cum_fg = n_b.cumsum(-1), fg_b.cumsum(-1)
    inter = (gts - cum_fg).float()
    union = (gts + cum_n - cum_fg).float()
    jac = 1.0 - inter / torch.clamp(union, min=1e-8)
    djac = torch.cat([jac[:, :1], jac[:, 1:] - jac[:, :-1]], dim=1)
    present = gts[:, 0] > 0
    coef = (djac / torch.clamp(n_b.float(), min=1.0)).flip(-1) \
        * present[:, None]
    return (coef.flatten().index_select(0, key.flatten()).view_as(errors),
            present)


def lovasz_softmax_hist(logits, labels, *, num_classes: int,
                        ignore_index: int = 255,
                        class_weights: Optional[torch.Tensor] = None,
                        n_buckets: int = 4096) -> torch.Tensor:
    """Counting-sweep Lovász-Softmax (the reference's
    ``lovasz_softmax_hist``): no sort. Each error is quantised to the key
    ``clip(trunc(e * (n_buckets - 1)), 0, n_buckets - 1)``; tied keys
    share their tie block's average Lovász gradient.

    Pass A counts each class's valid pixels and foreground pixels by key
    with an integer ``bincount`` (exact and deterministic at any size;
    the reference sums one-hot bf16 matmuls, exact below 2^24 a class)
    and turns the counts into the per-(class, key) coefficient ΔJaccard /
    count, zero for absent classes. Pass B gathers each pixel's
    coefficient in f32 (the reference rounds the table to bf16 there,
    up to 2^-8 relative) and returns ``Σ errors · coefficient`` over the
    present classes' mean. The coefficients carry no gradient, as the
    reference's ``stop_gradient``.
    """
    del class_weights
    errors, fg, valid = _lovasz_errors(logits, labels, num_classes,
                                       ignore_index)
    with torch.no_grad():
        coef, present = _lovasz_hist_coefficients(errors, fg, valid,
                                                  n_buckets)
    return _present_mean((errors * coef).sum(0), present)


LOSS_REGISTRY = {
    "ce": cross_entropy,
    "label_smoothing": partial(cross_entropy, label_smoothing=0.1),
    "ohem": ohem_cross_entropy,
    "focal": focal_loss,
    "lovasz": lovasz_softmax,
    "lovasz_hist": lovasz_softmax_hist,
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
