"""The reference's side of the comparison: plain PyTorch, f32 with TF32
off, on the benchmark's own weights and inputs.

- :func:`calibrate`: BN running statistics from one training pass at
  momentum 1 over a seeded batch, each variance floored (the predict
  cells' statistics, handed to the program as part of its weights).
- :func:`predict_gaps`: for each pixel of the program's class maps, how
  far the reference's upsampled logit of that class lies below its best.
- :func:`train_steps`: the first steps of the training route (weighted
  cross-entropy over the x8 bilinear upsample of the low-resolution
  logits, ignore label, Adam with L2 weight decay added to the gradient,
  the poly schedule), with the dropout masks drawn as the train step
  draws them.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    x &= _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def fold_in(seed: int, *data: int) -> int:
    """The rule by which the train step seeds a step's dropout generator
    from its own seed and the step count (splitmix64's finaliser), worked
    out again here."""
    x = _mix64(seed)
    for d in data:
        x = _mix64(x ^ _mix64(d + 0x9E3779B97F4A7C15))
    return x & ((1 << 63) - 1)


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """Float32 products without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _bns(model: nn.Module) -> List[L.BatchNorm]:
    return [m for m in model.modules() if isinstance(m, L.BatchNorm)]


def calibrate(model: L.ReferenceModel, images: torch.Tensor,
              var_floor: float) -> None:
    """Running statistics from one training pass at momentum 1 over
    ``images``; each variance floored at ``var_floor``. Leaves the model
    in eval mode."""
    bns = _bns(model)
    saved = [bn.momentum for bn in bns]
    for bn in bns:
        bn.momentum = 1.0
    model.train()
    with torch.no_grad(), exact_f32():
        model.logits_lowres(images)
    for bn, m in zip(bns, saved):
        bn.momentum = m
        bn.running_var.clamp_(min=var_floor)
    model.eval()


def predict_gaps(model: L.ReferenceModel, images: torch.Tensor,
                 maps: torch.Tensor, chunk: int) -> Dict[str, float]:
    """Judge class maps ``maps`` (N, H, W) of ``images`` (N, 3, H, W):
    the widest gap by which the reference's logit at a map's class lies
    below its best (``inf`` where a class is out of range or the shape is
    wrong), and how many pixels name another class than the reference's
    argmax. Eval mode, ``chunk`` images at a time."""
    n, _, h, w = images.shape
    classes = None
    if tuple(maps.shape) != (n, h, w):
        return {"widest": float("inf"), "mismatched": n * h * w,
                "pixels": n * h * w}
    widest, mismatched = 0.0, 0
    model.eval()
    with torch.no_grad(), exact_f32():
        for i in range(0, n, chunk):
            up = model(images[i:i + chunk])
            classes = up.shape[1]
            m = maps[i:i + chunk].to(up.device).long()
            if bool(((m < 0) | (m >= classes)).any()):
                return {"widest": float("inf"), "mismatched": n * h * w,
                        "pixels": n * h * w}
            best, arg = up.max(dim=1)
            gap = best - up.gather(1, m[:, None]).squeeze(1)
            # a NaN anywhere (in either side's numbers) reads as no bound
            widest = max(widest, float(torch.nan_to_num(gap, nan=float("inf"))
                                       .max()))
            mismatched += int((arg != m).sum())
            del up, best, arg, gap
    return {"widest": widest, "mismatched": mismatched, "pixels": n * h * w}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def train_steps(model: L.ReferenceModel, images: Sequence[torch.Tensor],
                labels: Sequence[torch.Tensor], class_weights: torch.Tensor,
                *, lr_at: Callable[[int], float], weight_decay: float,
                betas=(0.9, 0.999), eps: float = 1e-8, ignore: int = 255,
                dropout_seed: int, recompute: bool = False) -> Dict:
    """The first ``len(images)`` steps from the model's weights. Returns
    each step's loss, the per-leaf norms of the first step's raw gradient
    and of the gradient as Adam takes it (with ``weight_decay * p``
    added), and of each parameter's change over all the steps."""
    b1, b2 = betas
    params = dict(model.named_parameters())
    p0 = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    drops = [d for d in model.modules() if isinstance(d, L.Dropout)]
    for s in model.modules():
        if isinstance(s, L.Stage):
            s.recompute = recompute
    out: Dict = {"losses": []}
    model.train()
    with exact_f32():
        for t, (x, y) in enumerate(zip(images, labels)):
            gen = torch.Generator(device=x.device).manual_seed(
                fold_in(dropout_seed, t))
            for d in drops:
                d.draw = (lambda shape, g=gen, dev=x.device:
                          torch.rand(shape, generator=g, device=dev))
            for p in params.values():
                p.grad = None
            up = model(x)
            loss = F.cross_entropy(up, y.long(), weight=class_weights,
                                   ignore_index=ignore)
            del up
            loss.backward()
            out["losses"].append(float(loss.detach()))
            lr = float(lr_at(t))
            with torch.no_grad():
                grads = {k: p.grad + weight_decay * p
                         for k, p in params.items()}
                if t == 0:
                    out["grad_raw"] = _norms({k: p.grad
                                              for k, p in params.items()})
                    out["grad"] = _norms(grads)
                for k, p in params.items():
                    g = grads[k]
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = m[k] / (1 - b1 ** (t + 1))
                    vhat = v2[k] / (1 - b2 ** (t + 1))
                    p.sub_(lr * mhat / (vhat.sqrt() + eps))
            del grads
    for d in drops:
        d.draw = None
    out["change"] = _norms({k: p.detach() - p0[k]
                            for k, p in params.items()})
    return out
