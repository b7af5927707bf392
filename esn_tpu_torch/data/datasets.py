"""Dataset definitions: manifest-driven Cityscapes / CamVid and synthetic
data (counterpart of ``esn_tpu/data/datasets.py``).

The host decodes and stacks numpy records; augmentation runs on the
device (``data/augment.py``). Contracts, as the reference's:

- Cityscapes: 19 classes, ignore_label 255, source 1024x2048, BGR uint8,
  labels are trainID uint8 PNGs.
- CamVid: 11 classes, ignore_label 11, source 720x960.

An item is ``{"image": (H, W, 3) uint8 BGR, "label": (H, W) int32 (when
labelled), "name": str, "size": (2,) int32}``. Image files (PNG; JPEG
where libjpeg is installed) are decoded by the port's own C++ decoder,
``data/native.py``, into what ``cv2.imread`` returns, and resized with the
reference's native formulas; pre-packed ``.npy`` records need no codec and
are resized with the same functions. No module here imports cv2 or PIL.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import native


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_classes: int
    ignore_label: int
    source_hw: Tuple[int, int]
    default_crop_hw: Tuple[int, int]


CITYSCAPES = DatasetSpec("cityscapes", 19, 255, (1024, 2048), (512, 1024))
CAMVID = DatasetSpec("camvid", 11, 11, (720, 960), (360, 480))

SPECS = {"cityscapes": CITYSCAPES, "camvid": CAMVID}


def get_spec(name: str) -> DatasetSpec:
    key = name.lower()
    if key not in SPECS:
        raise KeyError(f"unknown dataset {name!r}; options {sorted(SPECS)}")
    return SPECS[key]


def read_manifest(list_path: str, root: Optional[str] = None
                  ) -> List[Tuple[str, Optional[str]]]:
    """Parse a split list file: ``image_path[<sep>label_path]`` per line,
    paths relative to ``root`` (default: the list file's directory)."""
    root = root or os.path.dirname(os.path.abspath(list_path))
    out = []
    with open(list_path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            img = parts[0] if os.path.isabs(parts[0]) \
                else os.path.join(root, parts[0])
            lab = None
            if len(parts) > 1:
                lab = parts[1] if os.path.isabs(parts[1]) \
                    else os.path.join(root, parts[1])
            out.append((img, lab))
    return out


class ManifestDataset:
    """Decoded (image BGR uint8 HWC, label int32 HW or None, name)
    records."""

    def __init__(self, records: Sequence[Tuple[str, Optional[str]]],
                 spec: DatasetSpec, resize_hw: Optional[Tuple[int, int]] = None):
        self.records = list(records)
        self.spec = spec
        self.resize_hw = resize_hw

    @classmethod
    def from_list_file(cls, list_path: str, spec: DatasetSpec,
                       root: Optional[str] = None, **kw):
        return cls(read_manifest(list_path, root), spec, **kw)

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        img_path, lab_path = self.records[i]
        if img_path.endswith(".npy"):
            return self._get_packed(i)
        # BGR, as the reference; bilinear image, nearest label
        image = native.decode_bgr(img_path, self.resize_hw)
        label = None if lab_path is None \
            else native.decode_grey(lab_path, self.resize_hw)
        return _item(image, label, img_path)

    def _get_packed(self, i: int) -> Dict[str, np.ndarray]:
        """A pre-packed record: one ``.npy`` holding (H, W, 4) uint8 (BGR
        image in channels 0..2, label in channel 3) or (H, W, 3) for an
        unlabeled test record, and optionally a separate (H, W) label
        ``.npy`` (the reference's ``tools/pack_dataset.py`` layout)."""
        img_path, lab_path = self.records[i]
        arr = np.load(img_path)
        if arr.ndim != 3 or arr.shape[-1] not in (3, 4):
            raise ValueError(
                f"packed record {img_path} has shape {arr.shape}; expected "
                "(H, W, 3|4) uint8")
        image = arr[..., :3]
        label = arr[..., 3] if arr.shape[-1] == 4 else None
        if lab_path is not None:
            label = np.load(lab_path)
            if label.ndim != 2:
                raise ValueError(f"packed label {lab_path} has shape "
                                 f"{label.shape}; expected (H, W)")
            label = label.astype(np.uint8, copy=False)
        if self.resize_hw is not None:
            hw = tuple(self.resize_hw)
            if tuple(image.shape[:2]) != hw:
                image = native.resize_bilinear(image, hw)
            # the label's own shape decides: it may be packed at another
            # resolution than its image
            if label is not None and tuple(label.shape[:2]) != hw:
                label = native.resize_nearest(label, hw)
        return _item(np.ascontiguousarray(image), label, img_path)

    def stats_samples(self):
        """Generator for the inform pass (train split only)."""
        for i in range(len(self)):
            item = self[i]
            yield item["image"], item["label"]


def _item(image: np.ndarray, label: Optional[np.ndarray], path: str):
    item = {"image": image.astype(np.uint8, copy=False),
            "name": os.path.basename(path),
            "size": np.array(image.shape[:2], np.int32)}
    if label is not None:
        item["label"] = label.astype(np.int32)
    return item


class SyntheticDataset:
    """Deterministic synthetic segmentation data for tests and smoke runs:
    the reference's items, bit for bit, for the same ``(seed, i)``.

    Images are 8x8-pixel blocks of a seeded random field; labels the
    argmax over ``num_classes`` random score maps of 32x32-pixel blocks,
    with a seeded fraction of ignored pixels. The reference builds both
    at full resolution with ``np.kron`` and takes the argmax there; here
    the blocks are repeated after the cast and the argmax (the same
    values: a block's pixels are copies of one value), which makes a
    1024x2048 item ~20x cheaper.
    """

    def __init__(self, spec: DatasetSpec, length: int = 32,
                 hw: Optional[Tuple[int, int]] = None, seed: int = 0,
                 with_labels: bool = True, ignore_frac: float = 0.02):
        self.spec = spec
        self.length = length
        self.hw = hw or spec.source_hw
        self.seed = seed
        self.with_labels = with_labels
        self.ignore_frac = ignore_frac

    def __len__(self):
        return self.length

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if not 0 <= i < self.length:
            raise IndexError(i)
        h, w = self.hw
        rng = np.random.RandomState(self.seed * 100003 + i)
        base = (rng.rand(h // 8 + 1, w // 8 + 1, 3) * 255).astype(np.uint8)
        image = base.repeat(8, 0).repeat(8, 1)[:h, :w]
        item = {"image": np.ascontiguousarray(image),
                "name": f"synthetic_{i:05d}.png",
                "size": np.array([h, w], np.int32)}
        if self.with_labels:
            k = self.spec.num_classes
            scores = rng.rand(h // 32 + 1, w // 32 + 1, k)
            low = np.argmax(scores, -1).astype(np.int32)
            label = np.ascontiguousarray(low.repeat(32, 0).repeat(32, 1)[:h, :w])
            label[rng.rand(h, w) < self.ignore_frac] = self.spec.ignore_label
            item["label"] = label
        return item

    def stats_samples(self):
        for i in range(len(self)):
            item = self[i]
            yield item["image"], item["label"]
