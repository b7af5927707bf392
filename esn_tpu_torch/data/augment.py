"""Train-time augmentation on the device (counterpart of
``esn_tpu/data/augment.py``).

The reference draws its random numbers inside one jitted program from a
``jax.random`` key. Those streams cannot be reproduced without jax, so
here the **draw** (:meth:`Augment.draw`: scale branch, crop offsets,
mirror flags, from a ``torch.Generator``, on the host) is apart from the
**apply** (:meth:`Augment.__call__`, on the tensors' device). Given the
reference's draws, the apply gives its images (to f32 rounding) and its
labels (exactly).

Two modes, as the reference's:

- ``batch`` (default): one scale per batch, crop-then-resize: crop
  ``round(C/s)`` source pixels (padded with 0 / ``ignore_label`` where
  that exceeds the source) and resize them to the crop ``C``.
- ``reference`` (``per_image_scale``): a scale per image,
  scale-then-crop: resize the whole image to ``(floor(H*s + 0.5),
  floor(W*s + 0.5))``, pad to at least the crop, crop.

Images are normalized (mean subtracted, optionally divided by std)
before the crop; the bilinear resize has no antialias and labels take
cv2's INTER_NEAREST indices (``ops.resize``). The mirror comes last.
Input: ``(B, H, W, 3)`` uint8 and ``(B, H, W)`` integer tensors, as the
loader stacks them; output: ``(B, 3, h, w)`` f32 in ``channels_last``
memory (the models' layout) and ``(B, h, w)`` int32.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize_bilinear, resize_nearest_cv2

DEFAULT_SCALES = (0.75, 1.0, 1.25, 1.5, 1.75, 2.0)
REFERENCE_SCALES = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0)


def normalize(images: torch.Tensor, mean, std=None) -> torch.Tensor:
    """f32 ``images - mean`` (``/ std`` where given), channels last."""
    x = images.float() - torch.as_tensor(mean, dtype=torch.float32,
                                         device=images.device)
    if std is not None:
        x = x / torch.as_tensor(std, dtype=torch.float32, device=images.device)
    return x


class _Normalizer:
    """:func:`normalize` with the mean and std kept on each device they
    were asked for, so a step copies nothing small to the card."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)
        self._on: Dict[torch.device, Tuple] = {}

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        dev = images.device
        if dev not in self._on:
            self._on[dev] = tuple(
                None if a is None else torch.from_numpy(a).to(dev)
                for a in (self.mean, self.std))
        mean, std = self._on[dev]
        return normalize(images, mean, std)


class Draws(NamedTuple):
    """One batch's random choices: the scale branch of each image (one
    value for the whole batch in ``batch`` mode), the crop's top-left
    corner in the (padded) image, and the mirror flags."""
    scale: List[int]
    y0: List[int]
    x0: List[int]
    flip: List[bool]

    def take(self, rows: Sequence[int]) -> "Draws":
        """The draws of these rows of the batch (a data-parallel rank's
        rows of the global batch's draws)."""
        return Draws(*([v[int(i)] for i in rows] for v in self))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class Augment:
    """``augment(images_u8, labels, draws) -> (images_f32 NCHW, labels)``;
    see :func:`make_augment_fn`."""

    def __init__(self, *, crop_hw, source_hw, mean, std=None,
                 ignore_label=255, scales=None, random_scale=True,
                 random_mirror=True, per_image_scale=False):
        self.crop_hw = tuple(crop_hw)
        self.source_hw = tuple(source_hw)
        self.normalize = _Normalizer(mean, std)
        self.ignore_label = ignore_label
        self.random_mirror = random_mirror
        self.per_image_scale = per_image_scale
        if scales is None:
            scales = REFERENCE_SCALES if per_image_scale else DEFAULT_SCALES
        self.scales = list(scales) if random_scale else [1.0]
        ch, cw = self.crop_hw
        h, w = self.source_hw
        if per_image_scale:     # the scaled image, padded to the crop
            sized = [(int(np.floor(h * s + 0.5)), int(np.floor(w * s + 0.5)))
                     for s in self.scales]
            self._scaled = sized
            self._room = [(max(a, ch) - ch + 1, max(b, cw) - cw + 1)
                          for a, b in sized]
        else:                   # the source crop, padded to the source
            self._src = [(int(round(ch / s)), int(round(cw / s)))
                         for s in self.scales]
            self._room = [(max(h, a) - a + 1, max(w, b) - b + 1)
                          for a, b in self._src]

    def draw(self, generator: torch.Generator, batch: int) -> Draws:
        """The batch's draws from ``generator`` (a CPU generator)."""
        k = len(self.scales)
        if self.per_image_scale:
            scale = torch.randint(k, (batch,), generator=generator).tolist()
        else:
            scale = [int(torch.randint(k, (), generator=generator))] * batch
        y0 = [int(torch.randint(self._room[s][0], (), generator=generator))
              for s in scale]
        x0 = [int(torch.randint(self._room[s][1], (), generator=generator))
              for s in scale]
        if self.random_mirror:
            flip = (torch.rand(batch, generator=generator) < 0.5).tolist()
        else:
            flip = [False] * batch
        return Draws(scale, y0, x0, flip)

    def _pad(self, x, y, pad_h, pad_w):
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
            y = F.pad(y, (0, pad_w, 0, pad_h), value=self.ignore_label)
        return x, y

    def _crop_then_resize(self, x, y, d: Draws):
        src_h, src_w = self._src[d.scale[0]]
        h, w = self.source_hw
        x, y = self._pad(x, y, max(src_h - h, 0), max(src_w - w, 0))
        xs = torch.stack([x[i, a:a + src_h, b:b + src_w]
                          for i, (a, b) in enumerate(zip(d.y0, d.x0))])
        ys = torch.stack([y[i, a:a + src_h, b:b + src_w]
                          for i, (a, b) in enumerate(zip(d.y0, d.x0))])
        out = resize_bilinear(_nchw(xs), self.crop_hw)
        return out, resize_nearest_cv2(ys, self.crop_hw)

    def _scale_then_crop(self, x, y, d: Draws):
        ch, cw = self.crop_hw
        xs, ys = [], []
        for i, (s, a, b) in enumerate(zip(d.scale, d.y0, d.x0)):
            hs, ws = self._scaled[s]
            xi = resize_bilinear(_nchw(x[i:i + 1]), (hs, ws)).permute(0, 2, 3, 1)
            yi = resize_nearest_cv2(y[i:i + 1], (hs, ws))
            xi, yi = self._pad(xi, yi, max(ch - hs, 0), max(cw - ws, 0))
            xs.append(xi[0, a:a + ch, b:b + cw])
            ys.append(yi[0, a:a + ch, b:b + cw])
        return _nchw(torch.stack(xs)), torch.stack(ys)

    def __call__(self, images: torch.Tensor, labels: torch.Tensor,
                 draws: Draws) -> Tuple[torch.Tensor, torch.Tensor]:
        if tuple(images.shape[1:3]) != self.source_hw:
            raise ValueError(f"expected source {self.source_hw}, got "
                             f"{tuple(images.shape)}")
        x = self.normalize(images)
        y = labels.to(torch.int32)
        if self.per_image_scale:
            x, y = self._scale_then_crop(x, y, draws)
        else:
            x, y = self._crop_then_resize(x, y, draws)
        if any(draws.flip):
            x = torch.stack([xi.flip(-1) if f else xi
                             for xi, f in zip(x, draws.flip)])
            y = torch.stack([yi.flip(-1) if f else yi
                             for yi, f in zip(y, draws.flip)])
        return x.contiguous(memory_format=torch.channels_last), y.contiguous()


def make_augment_fn(*, crop_hw: Tuple[int, int], source_hw: Tuple[int, int],
                    mean: np.ndarray, std: Optional[np.ndarray] = None,
                    ignore_label: int = 255,
                    scales: Optional[Sequence[float]] = None,
                    random_scale: bool = True, random_mirror: bool = True,
                    per_image_scale: bool = False) -> Augment:
    """The reference's ``make_augment_fn``; ``per_image_scale`` is its
    ``--aug_mode reference``. Call ``augment.draw(generator, batch)``,
    then ``augment(images, labels, draws)``."""
    return Augment(crop_hw=crop_hw, source_hw=source_hw, mean=mean, std=std,
                   ignore_label=ignore_label, scales=scales,
                   random_scale=random_scale, random_mirror=random_mirror,
                   per_image_scale=per_image_scale)


def make_eval_transform(*, mean: np.ndarray, std: Optional[np.ndarray] = None,
                        resize_hw: Optional[Tuple[int, int]] = None):
    """Val/test transform: ``(B, H, W, 3)`` uint8 -> normalized ``(B, 3,
    H, W)`` f32 in ``channels_last`` memory, optionally resized."""
    norm = _Normalizer(mean, std)

    def transform(images: torch.Tensor) -> torch.Tensor:
        x = _nchw(norm(images))
        if resize_hw is not None:
            x = resize_bilinear(x, resize_hw)
        return x.contiguous(memory_format=torch.channels_last)

    return transform
