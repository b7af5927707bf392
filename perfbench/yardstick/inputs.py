"""The traffic's inputs, made on the device from the seed.

Images are smooth random fields, f32 NCHW as a loader hands them over: a
normal field at 1/32 resolution upsampled, plus a little pixel noise, so
that images differ in their global means. Labels are the argmax of a
smooth random field over the classes (1/16 resolution, upsampled) with a
band of 32 ignored rows across the middle. Class weights are the
reference's ``1 / ln(1.10 + p_c)`` of the labels' class histogram.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .seeds import derive


def _gen(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def images(seed: int, slot: int, n: int, hw: Sequence[int],
           device) -> torch.Tensor:
    g = _gen(device, seed, "images", slot)
    h, w = hw
    low = torch.randn((n, 3, max(h // 32, 1), max(w // 32, 1)), generator=g,
                      device=device)
    x = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    return x + 0.1 * torch.randn((n, 3, h, w), generator=g, device=device)


def labels(seed: int, slot: int, n: int, hw: Sequence[int], classes: int,
           ignore: int, device) -> torch.Tensor:
    g = _gen(device, seed, "labels", slot)
    h, w = hw
    out = torch.empty((n, h, w), dtype=torch.int32, device=device)
    for i in range(n):       # one image's field at a time: 19 x H x W f32
        low = torch.randn((1, classes, max(h // 16, 1), max(w // 16, 1)),
                          generator=g, device=device)
        field = F.interpolate(low, size=(h, w), mode="bilinear",
                              align_corners=False)
        out[i] = field[0].argmax(0).to(torch.int32)
    band = min(16, h // 4)
    out[:, h // 2 - band:h // 2 + band] = ignore
    return out


def class_weights(label_batches: Sequence[torch.Tensor], classes: int,
                  norm_val: float = 1.10) -> torch.Tensor:
    hist = torch.zeros(classes, dtype=torch.float64,
                       device=label_batches[0].device)
    for lab in label_batches:
        valid = lab[(lab >= 0) & (lab < classes)].long()
        hist += torch.bincount(valid, minlength=classes).double()
    p = hist / hist.sum()
    return (1.0 / torch.log(norm_val + p)).float()


def pool(seed: int, size: int, n: int, hw: Sequence[int], classes: int,
         ignore: int, device, with_labels: bool
         ) -> Tuple[list, list]:
    """``size`` distinct batches of ``n`` images (and labels)."""
    ims = [images(seed, s, n, hw, device) for s in range(size)]
    labs = [labels(seed, s, n, hw, classes, ignore, device)
            for s in range(size)] if with_labels else []
    return ims, labs
