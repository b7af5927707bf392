"""Step builders (counterpart of ``esn_tpu/train/step.py``).

The reference's ``TrainState`` (``train/state.py``) has no counterpart:
the model holds the parameters and the BN running statistics, the
``torch.optim`` optimizer holds its state, and :class:`TrainStep` holds
the step count. The reference's pure step returns a new state; here the
step updates the parameters, the optimizer state and the running
statistics in place.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..nn import Recompute, SegModel, set_dropout_generator
from ..ops.classify import argmax_lastdim
from ..ops.resize import resize_bilinear
from ..parallel import mesh, spatial
from .metrics import confusion_matrix

_MASK63 = (1 << 63) - 1


def _mix64(x: int) -> int:
    """splitmix64's finaliser."""
    x &= (1 << 64) - 1
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return x ^ (x >> 31)


def fold_in(seed: int, *data: int) -> int:
    """A seed derived from ``seed`` and the integers ``data`` (the role of
    ``jax.random.fold_in``; not its bits)."""
    x = _mix64(seed)
    for d in data:
        x = _mix64(x ^ _mix64(d + 0x9E3779B97F4A7C15))
    return x & _MASK63


class TrainStep:
    """``step(batch) -> {"loss", "lr"}``; see :func:`make_train_step`.
    ``count`` is the number of steps taken (the schedule's step)."""

    def __init__(self, model: SegModel, loss_fn: Callable,
                 optimizer: torch.optim.Optimizer, *,
                 schedule: Optional[Callable[[int], float]],
                 compute_dtype: torch.dtype, grad_accum: int,
                 fwd_method: Optional[str],
                 generator: Optional[torch.Generator], remat: bool):
        if grad_accum < 1:
            raise ValueError(f"grad_accum={grad_accum} must be >= 1")
        self.model, self.loss_fn, self.optimizer = model, loss_fn, optimizer
        self.schedule, self.compute_dtype = schedule, compute_dtype
        self.grad_accum, self.fwd_method = grad_accum, fwd_method
        self.recompute = Recompute(model) if remat else None
        self.seed = None if generator is None else generator.initial_seed()
        self.device = next(model.parameters()).device
        self.count = 0

    def _loss(self, images: torch.Tensor, labels: torch.Tensor,
              *rng_data: int) -> torch.Tensor:
        if self.seed is not None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(fold_in(self.seed, self.count, *rng_data))
            set_dropout_generator(self.model, gen)
        x = images.to(device=self.device, dtype=self.compute_dtype,
                      memory_format=torch.channels_last)
        if self.recompute is None:
            logits = self.model.run(x, self.fwd_method)
        else:
            logits = checkpoint(self.model.run, x, self.fwd_method,
                                use_reentrant=False,
                                context_fn=self.recompute.contexts)
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        return self.loss_fn(logits.permute(0, 2, 3, 1), labels)

    def _forward_backward(self, images: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
        """The loss and its gradients (``grad_accum`` microbatches in
        order, averaged), before the sums over the ranks."""
        ga = self.grad_accum
        if ga == 1:
            loss = self._loss(images, labels)
            loss.backward()
            return loss.detach()
        b = images.shape[0]
        if b % ga:
            raise ValueError(f"batch {b} not divisible by grad_accum={ga}")
        mb = b // ga
        loss = torch.zeros((), device=self.device)
        # microbatches in order: each BN update sees the last one's running
        # stats, as the reference's scan threads them
        for i in range(ga):
            sl = slice(i * mb, (i + 1) * mb)
            li = self._loss(images[sl], labels[sl], i)
            li.backward()
            loss = loss + li.detach()
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.div_(ga)
        return loss / ga

    def __call__(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor | float]:
        self.model.train()
        images = batch["image"]
        labels = batch["label"].to(device=self.device, dtype=torch.int32)
        self.optimizer.zero_grad(set_to_none=True)
        with spatial.sharded():
            loss = self._forward_backward(images, labels)
        # the ranks' parts of the global loss and gradient, summed
        loss, = mesh.all_reduce_grads(
            (p for g in self.optimizer.param_groups for p in g["params"]),
            loss)
        metrics: Dict[str, torch.Tensor | float] = {"loss": loss}
        if self.schedule is not None:
            lr = float(self.schedule(self.count))
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            metrics["lr"] = lr
        self.optimizer.step()
        self.count += 1
        return metrics


def make_train_step(model: SegModel, loss_fn: Callable,
                    optimizer: torch.optim.Optimizer, *,
                    schedule: Optional[Callable[[int], float]] = None,
                    compute_dtype: torch.dtype = torch.float32,
                    grad_accum: int = 1, fwd_method: Optional[str] = None,
                    generator: Optional[torch.Generator] = None,
                    remat: bool = False) -> TrainStep:
    """Build ``step(batch) -> metrics`` for batches ``{"image": (N, C, H,
    W) float, "label": (N, H, W) int}``.

    Each call puts the model in train mode, casts the images to
    ``compute_dtype`` in ``channels_last`` (parameters stay f32), casts the
    labels once to int32, runs the forward (``fwd_method``, e.g.
    ``"logits_lowres"`` paired with ``losses.resize_cross_entropy``),
    ``loss_fn(logits NHWC f32, labels)``, one backward (``grad_accum``
    microbatches in order, gradients averaged), sets the optimizer's lr
    to ``schedule(count)`` at the current count (starting at 0) and steps
    the optimizer. BN running stats update in place. Dropout masks come
    from a generator seeded from ``generator``'s seed, the step count and
    the microbatch index (the reference folds them into its rng).
    Metrics: ``loss`` (a device scalar; the microbatch mean under
    accumulation) and ``lr``.

    Under a data-parallel group (``parallel.mesh``) the batch is this
    rank's rows (``mesh.shard_batch``, with the same ``grad_accum``) and
    the step is the reference's global-batch step: the BN moments, the
    losses' normalisers and dropout's draws are the global batch's (see
    ``nn.BatchNorm``, ``train.losses``), each rank's loss is its part of
    the global loss, the gradients and that loss are summed over the ranks
    in one flat all-reduce after the backward, and every rank steps its
    optimizer alike. ``loss`` is then the global loss on every rank.

    Under spatial sharding (``parallel.spatial``; the world laid out as
    ``(data, model)``) the batch is this rank's batch rows' image rows
    (``spatial.shard_batch_spatial``) and the forward and backward run
    inside ``spatial.sharded()``: every op exchanges the rows it reads
    across shards, whole-height reductions are summed over the model
    group, and the sums over the world above are unchanged. Pair it with
    the model's full forward and a plain loss (``fwd_method`` None), as
    the reference's spatial step does: the fused resize-CE loss raises
    there.

    ``remat=True`` recomputes the model's forward during the backward
    (the reference's ``jax.checkpoint``), each microbatch's on its own: a
    non-reentrant ``torch.utils.checkpoint`` around ``model.run``, whose
    :class:`~esn_tpu_torch.nn.Recompute` contexts make the recompute
    centre each BN on the running mean the first run saw, move no
    running statistic and draw the first run's dropout masks. The loss,
    gradients and BN statistics are those of the step without it. The
    loss stays outside the checkpoint (the reference recomputes it too;
    the value is the same), so a fused resize-CE loss launches its kernel
    once forward and once backward a step, as without ``remat``.
    """
    return TrainStep(model, loss_fn, optimizer, schedule=schedule,
                     compute_dtype=compute_dtype, grad_accum=grad_accum,
                     fwd_method=fwd_method, generator=generator, remat=remat)


def make_predict_step(model: SegModel, *,
                      compute_dtype: torch.dtype = torch.float32,
                      output_size: Optional[Tuple[int, int]] = None,
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``predict(images) -> pred (N, H, W) int32`` for images
    ``(N, C, H, W)`` on the model's device.

    Every call puts the model in eval mode before its forward (the
    reference passes ``train=False`` on every predict call), so a predict
    after a train step of the same model normalises with the running
    statistics, leaves them alone and takes the fused eval paths. A call
    reads the ``training`` flag of each module the model had when the step
    was built, and walks the model with ``model.eval()`` only where one is
    set: the walk is the costlier by far, and predict is bound by its host
    time. Images are cast to ``compute_dtype`` in ``channels_last`` memory;
    parameters stay f32 and each op casts them to the activation dtype.
    With ``output_size`` the full-res logits are
    resized (f32 bilinear) to it before the argmax; otherwise the model's
    own ``predict`` runs (the fused resize + argmax tail where it has one).
    """
    modules = list(model.modules())

    @torch.inference_mode()
    def predict(images: torch.Tensor) -> torch.Tensor:
        if any(m.training for m in modules):
            model.eval()
        x = images.to(dtype=compute_dtype, memory_format=torch.channels_last)
        if output_size is not None:
            logits = resize_bilinear(model(x).float(), output_size)
            return argmax_lastdim(logits.permute(0, 2, 3, 1))
        return model.predict(x)

    return predict


def make_eval_step(model: SegModel, num_classes: int, *,
                   ignore_index: int = 255,
                   compute_dtype: torch.dtype = torch.float32) -> Callable:
    """Build ``eval_step(batch) -> (pred (N, H, W) int32, cm (K, K)
    int64)`` for batches ``{"image": (N, C, H, W) float, "label":
    (N, H, W) int}``; both results stay on the model's device
    (``eval_step.device``), where the batch is moved if it lies elsewhere.

    The prediction is the model's own ``predict`` (the fused resize +
    argmax tail where it has one), run as :func:`make_predict_step` runs
    it: in eval mode on every call, whatever a train step left behind.
    With ``"valid"`` (an int) in the batch only the first ``valid`` rows
    count: the padded tail rows of a fixed-shape eval batch
    (``train.evaluation.pad_batch_to``) are masked to ``ignore_index``
    before the confusion matrix. The reference's ``trace_count`` has no
    counterpart: nothing is traced or compiled here.

    Under a data-parallel group the batch is this rank's rows, ``valid``
    counts this rank's real rows, and ``cm`` is summed over the ranks
    (int64), the reference's global bincount; ``pred`` stays this rank's.
    """
    predict = make_predict_step(model, compute_dtype=compute_dtype)
    device = next(model.parameters()).device

    @torch.inference_mode()
    def eval_step(batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        pred = predict(batch["image"].to(device))
        labels = batch["label"].to(device)
        if pred.shape != labels.shape:
            raise ValueError(
                f"model output {tuple(pred.shape[1:])} != label "
                f"{tuple(labels.shape[1:])}"
                f" - the eval resolution must be divisible by the model's"
                f" output stride (the reference assumes this implicitly:"
                f" CamVid 360x480, Cityscapes 1024x2048 are both divisible"
                f" by 8). Fix: --val_size H,W with compatible H,W.")
        if "valid" in batch:
            labels = labels.clone()
            labels[int(batch["valid"]):] = ignore_index
        return pred, mesh.all_sum(confusion_matrix(pred, labels, num_classes,
                                                   ignore_index))

    eval_step.device = device
    return eval_step
