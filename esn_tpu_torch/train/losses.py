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

Under a data-parallel group (``parallel.mesh``) each rank's loss is its
part of the reference's loss on the global batch, so the ranks' losses
sum to it and their gradients sum to its gradient: the normalisers
(``Σw`` of CE, label smoothing, the K3 route, OHEM's kept pixels and
focal) are summed over the ranks, OHEM's ``min_kept`` and threshold are
those of the global batch (:func:`kth_smallest`), and the Lovász losses
take their coefficients and classes present from the global batch.
Under spatial sharding a rank's pixels are its shard of the global rows,
which need not be an equal piece: the global pixel count and the Lovász
gather take every rank's own count (:func:`_rank_pixels`). An f64 input
keeps f64 throughout (f32 otherwise).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import torch

from ..ops import kernels as K
from ..ops.resize import resize_bilinear
from ..parallel import mesh, spatial


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or in f64 where it is f64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _per_pixel_ce(logits: torch.Tensor, labels: torch.Tensor,
                  num_classes: int, ignore_index: int,
                  label_smoothing: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(nll per pixel f32 (f64 for f64 logits), labels safe for lookup,
    valid mask)."""
    x = _wide(logits)
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
                   mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    w = mask.to(dtype)
    if class_weights is not None:
        w = w * class_weights.to(dtype)[safe]
    return w


def _rank_pixels(logits: torch.Tensor) -> Tuple[int, ...]:
    """The pixels each rank of the world holds of the global batch's NHWC
    logits, of which this rank holds ``logits``: equal pieces, except
    under spatial sharding, where rank ``r`` holds its model index's
    shard of the global rows (``spatial.bounds``)."""
    n, h, w, _ = logits.shape
    world = mesh.world()
    ax = spatial.axis()
    if ax is None:
        return (n * h * w,) * world.size
    b = spatial.bounds(spatial.global_rows(ax, h)[0], ax.size)
    return tuple(n * w * (b[r % ax.size + 1] - b[r % ax.size])
                 for r in range(world.size))


def _global_pixels(logits: torch.Tensor) -> int:
    """The global batch's pixels (the one-process ``N*H*W``)."""
    if not mesh.active():
        n, h, w, _ = logits.shape
        return n * h * w
    return sum(_rank_pixels(logits))


def _normalised(total: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``total / max(Σ weight, 1e-8)`` with the weight summed over the
    global batch: each rank's part of the reference's global loss (the
    weights carry no gradient)."""
    return total / torch.clamp(mesh.all_sum(weight.detach()), min=1e-8)


def cross_entropy(logits, labels, *, num_classes: int,
                  class_weights: Optional[torch.Tensor] = None,
                  ignore_index: int = 255,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Class-weighted CE with ignore_index, torch reduction semantics."""
    nll, safe, valid = _per_pixel_ce(logits, labels, num_classes,
                                     ignore_index, label_smoothing)
    w = _pixel_weights(class_weights, safe, valid, nll.dtype)
    return _normalised((w * nll).sum(), w.sum())


def resize_cross_entropy(z, labels, *, num_classes: int,
                         class_weights: Optional[torch.Tensor] = None,
                         ignore_index: int = 255,
                         label_smoothing: float = 0.0) -> torch.Tensor:
    """CE(bilinear_upsample(z), labels) for low-res NHWC logits z.

    An integer isotropic scale 2 <= r <= 16 runs the fused kernel (z f32
    contiguous NHWC, labels int32 on the card); any other scale
    upsamples in f32 and takes :func:`cross_entropy`, as the reference's
    materialized path does. Under spatial sharding it raises: its
    upsample would read rows across shards, which the kernel does not;
    the spatial step takes the model's full forward and the plain loss
    (the Trainer's route).
    """
    if spatial.axis() is not None:
        raise ValueError(
            "resize_cross_entropy: the fused resize-CE loss reads no rows "
            "across shards; under spatial sharding take the model's full "
            "forward with the plain loss (build_loss)")
    b, h, w, c = z.shape
    hl, wl = labels.shape[1], labels.shape[2]
    r = hl // h
    if (hl % h or wl % w or r != wl // w
            or not 2 <= r <= K.resize_ce.MAX_FACTOR):
        full = resize_bilinear(_wide(z).permute(0, 3, 1, 2), (hl, wl))
        return cross_entropy(full.permute(0, 2, 3, 1), labels,
                             num_classes=num_classes,
                             class_weights=class_weights,
                             ignore_index=ignore_index,
                             label_smoothing=label_smoothing)
    s, n = K.resize_ce_sums(_wide(z), labels, class_weights, r=r,
                            ignore_index=ignore_index,
                            label_smoothing=label_smoothing)
    return _normalised(s, n)


def kth_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """The exact ``k``-th smallest (1-indexed) of the non-negative finite
    values ``x`` (f32 or f64) of every rank together, as a 0-d tensor: the
    reference's radix select (``esn_tpu/train/losses.py`` ``kth_smallest``)
    over the IEEE-754 bit patterns, which order as the values do for
    ``x >= 0``. Each level resolves one nibble of the answer from 16
    counts, ``count(bits <= lo | d << shift | low_mask)`` for d = 0..15,
    taken as the count below the resolved prefix plus a cumulative
    histogram of the next nibble among the values that share it; the
    counts are summed over the ranks (int64), so the answer is bit for bit
    the one-process value, ties across ranks included."""
    wide, same_width, nbits = (
        (torch.float64, torch.int64, 64) if x.dtype == torch.float64
        else (torch.float32, torch.int32, 32))
    bits = x.detach().to(wide).reshape(-1).view(same_width).long()
    lo = torch.zeros((), dtype=torch.int64, device=x.device)
    for shift in range(nbits - 4, -1, -4):
        if shift + 4 < nbits:
            high, prefix = bits >> (shift + 4), lo >> (shift + 4)
            below = (high < prefix).sum()
            nibble = torch.where(high == prefix, (bits >> shift) & 15, 16)
        else:
            below = torch.zeros((), dtype=torch.int64, device=x.device)
            nibble = bits >> shift
        hist = torch.bincount(nibble, minlength=17)[:16]
        counts = mesh.all_sum(torch.cat([below.reshape(1), hist]))
        counts = counts[0] + counts[1:].cumsum(0)
        lo = lo | ((counts < k).sum() << shift)
    return lo.to(same_width).view(wide)


def ohem_threshold(p_true: torch.Tensor, thresh: float,
                   min_kept: int) -> torch.Tensor:
    """``max(thresh, the min_kept-th smallest of p_true)`` over the global
    batch: ``torch.topk`` in one process, :func:`kth_smallest` (the same
    value, bit for bit) under a data-parallel group, where a top-k cannot
    be reduced across ranks."""
    if mesh.active():
        kth = kth_smallest(p_true, min_kept)
    else:
        # the min_kept-th smallest as the largest of the min_kept
        # smallest: torch.kthvalue selects within one slice by a single
        # block on CUDA (121 ms for the 16.7 M probabilities of a batch of
        # 8 at 1024x2048 on an H100, where this topk stays under 1 ms; the
        # same value)
        kth = torch.topk(p_true, min_kept, largest=False,
                         sorted=False).values.max()
    return torch.clamp(kth, min=thresh)


def ohem_kept_mask(nll: torch.Tensor, valid: torch.Tensor, thresh: float,
                   min_kept: int) -> torch.Tensor:
    """OHEM's kept pixels, flat: true-class probability at or below
    :func:`ohem_threshold`; ignored pixels count as probability 2 and are
    never kept."""
    p_true = torch.where(valid, torch.exp(-nll), torch.full_like(nll, 2.0))
    p_true = p_true.reshape(-1)
    threshold = ohem_threshold(p_true, thresh, min_kept)
    return (p_true <= threshold) & valid.reshape(-1)


def ohem_cross_entropy(logits, labels, *, num_classes: int,
                       class_weights: Optional[torch.Tensor] = None,
                       ignore_index: int = 255, thresh: float = 0.7,
                       min_kept: Optional[int] = None) -> torch.Tensor:
    """Online hard example mining CE (reference ProbOhemCrossEntropy2d):
    CE over the kept pixels of :func:`ohem_kept_mask`, at least
    ``min_kept`` (default ``B*H*W // 16`` of the global batch) of them."""
    total = _global_pixels(logits)
    if min_kept is None:
        min_kept = max(total // 16, 1)
    min_kept = int(min(min_kept, total))
    nll, safe, valid = _per_pixel_ce(logits, labels, num_classes,
                                     ignore_index)
    kept = ohem_kept_mask(nll.detach(), valid, thresh, min_kept)
    wpix = _pixel_weights(class_weights, safe.reshape(-1), kept, nll.dtype)
    return _normalised((wpix * nll.reshape(-1)).sum(), wpix.sum())


def focal_loss(logits, labels, *, num_classes: int,
               class_weights: Optional[torch.Tensor] = None,
               ignore_index: int = 255, gamma: float = 2.0) -> torch.Tensor:
    """Focal loss (the reference's FocalLoss2d, gamma 2): ``(1 -
    p_y)^gamma * ce`` per pixel, reduced as :func:`cross_entropy`; gamma 0
    is :func:`cross_entropy`."""
    nll, safe, valid = _per_pixel_ce(logits, labels, num_classes,
                                     ignore_index)
    focal = torch.pow(1.0 - torch.exp(-nll), gamma) * nll
    w = _pixel_weights(class_weights, safe, valid, nll.dtype)
    return _normalised((w * focal).sum(), w.sum())


def _lovasz_errors(logits, labels, num_classes: int, ignore_index: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(errors, fg, valid)`` of every pixel and class, flat ``(N, C)``:
    ``fg`` the one-hot of valid labels (f32; f64 for f64 logits),
    ``errors = |fg - softmax|``, 0 at ignored pixels (they sort last and
    add nothing)."""
    probs = torch.softmax(_wide(logits), dim=-1).reshape(-1, num_classes)
    labels = labels.reshape(-1).long()
    valid = (labels != ignore_index) & (labels >= 0) & (labels < num_classes)
    fg = _one_hot(labels, valid, num_classes, probs.dtype)
    errors = (fg - probs).abs() * valid[:, None]
    return errors, fg, valid


def _one_hot(labels: torch.Tensor, valid: torch.Tensor, num_classes: int,
             dtype: torch.dtype) -> torch.Tensor:
    classes = torch.arange(num_classes, device=labels.device)
    return ((labels[:, None] == classes) & valid[:, None]).to(dtype)


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

    Under a data-parallel group the sort needs every rank's errors: they
    and the valid labels are gathered (``parallel.mesh.gather_rows``, an
    all-reduce of a zero buffer), each rank sorts the global batch's
    errors and keeps its own rows' coefficients, so each rank's loss is
    its rows' part of the global one and back-propagates into its rows
    only.
    """
    del class_weights
    errors, fg, valid = _lovasz_errors(logits, labels, num_classes,
                                       ignore_index)
    with torch.no_grad():
        if mesh.active():
            counts = _rank_pixels(logits)
            all_labels = mesh.gather_rows(torch.where(
                valid, labels.reshape(-1).long(), -1), counts)
            all_fg = _one_hot(all_labels, all_labels >= 0, num_classes,
                              fg.dtype)
            at = sum(counts[:mesh.world().rank])
            coef = _lovasz_sort_coefficients(
                mesh.gather_rows(errors.detach(), counts), all_fg
            )[at:at + errors.shape[0]]
            present = all_fg.sum(0) > 0
        else:
            coef = _lovasz_sort_coefficients(errors, fg)
            present = fg.sum(0) > 0
    return _present_mean((errors * coef).sum(0), present)


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
    # the counts of the global batch (int64, summed over the ranks)
    n_b = mesh.all_sum(torch.bincount(
        torch.where(valid[:, None], key, spare).flatten(),
        minlength=c * nb + 1))
    fg_b = mesh.all_sum(torch.bincount(
        torch.where(fg.bool(), key, spare).flatten(), minlength=c * nb + 1))
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
    coef = coef.to(errors.dtype)
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
    reference's ``stop_gradient``. Under a data-parallel group the counts
    are summed over the ranks (int64), so every rank has the global
    coefficients and the global classes present.
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
