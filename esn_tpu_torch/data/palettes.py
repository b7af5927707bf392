"""Label palettes, trainID -> labelID, prediction writers (counterpart of
``esn_tpu/data/palettes.py``).

Cityscapes/CamVid colour palettes, ``save_predict`` (grey trainID PNG, a
colourised PNG, Cityscapes trainID -> labelID for the evaluation server).
PNGs go through the port's own writer (``data/png.py``), on every
machine: the pixels PIL would write.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .png import write_png

# Cityscapes: 19 train classes; trainID -> labelID (for server submission)
CITYSCAPES_TRAINID_TO_LABELID = np.array(
    [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33],
    dtype=np.uint8)

CITYSCAPES_PALETTE = np.array([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32]], dtype=np.uint8)

CITYSCAPES_CLASSES = [
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle"]

CAMVID_PALETTE = np.array([
    [128, 128, 128], [128, 0, 0], [192, 192, 128], [128, 64, 128],
    [60, 40, 222], [128, 128, 0], [192, 128, 128], [64, 64, 128],
    [64, 0, 128], [64, 64, 0], [0, 128, 192]], dtype=np.uint8)

CAMVID_CLASSES = [
    "sky", "building", "pole", "road", "pavement", "tree", "sign symbol",
    "fence", "car", "pedestrian", "bicyclist"]


def colorize_mask(mask: np.ndarray, palette: np.ndarray,
                  ignore_color=(0, 0, 0)) -> np.ndarray:
    """(H, W) trainIDs -> (H, W, 3) RGB; out-of-range ids -> ignore_color."""
    k = palette.shape[0]
    table = np.vstack([palette, np.full((256 - k, 3), ignore_color,
                                        np.uint8)])
    return table[mask.astype(np.uint8)]


def trainid_to_labelid(mask: np.ndarray) -> np.ndarray:
    """Cityscapes trainID map -> labelID map (255 -> 0 'unlabeled')."""
    table = np.zeros(256, np.uint8)
    table[:19] = CITYSCAPES_TRAINID_TO_LABELID
    return table[mask.astype(np.uint8)]


def palette_for(dataset: str) -> np.ndarray:
    return CITYSCAPES_PALETTE if dataset.lower().startswith("city") \
        else CAMVID_PALETTE


def save_predict(pred: np.ndarray, gt: Optional[np.ndarray], name: str,
                 dataset: str, save_dir: str, *, output_grey: bool = False,
                 output_color: bool = True, gt_color: bool = False) -> None:
    """Write prediction PNGs, named after ``name`` in ``save_dir``.

    - output_grey: ``{base}.png``, the raw ids; for Cityscapes converted
      trainID -> labelID so the file is server-submittable.
    - output_color: ``{base}_color.png``, palette-colourised.
    - gt_color: ``{base}_gt.png``, the colourised ground truth.
    """
    os.makedirs(save_dir, exist_ok=True)
    base = os.path.join(save_dir, os.path.splitext(os.path.basename(name))[0])
    if output_grey:
        grey = trainid_to_labelid(pred) if dataset.lower().startswith("city") \
            else pred.astype(np.uint8)
        write_png(base + ".png", grey)
    if output_color:
        write_png(base + "_color.png", colorize_mask(pred, palette_for(dataset)))
    if gt_color and gt is not None:
        write_png(base + "_gt.png", colorize_mask(gt, palette_for(dataset)))
