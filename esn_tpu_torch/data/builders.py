"""Dataset builders (counterpart of ``esn_tpu/data/builders.py``).

``build_dataset_train`` / ``build_dataset_test`` pick the list file by
split, load or compute the inform statistics and return loaders, with the
reference's seeds and lengths. The train loader yields raw uint8 numpy
batches; augmentation runs on the device through the returned
:class:`~esn_tpu_torch.data.augment.Augment`.

Where the dataset root has no list file for a split, the builders use
:class:`~esn_tpu_torch.data.datasets.SyntheticDataset` (train seed 0, val
seed 1, test seed 2, as the reference), and say so.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

from .augment import make_augment_fn, make_eval_transform
from .datasets import ManifestDataset, SyntheticDataset, get_spec
from .inform import load_or_compute_inform
from .loader import BatchLoader

DEFAULT_ROOT = os.environ.get("ESN_DATA_ROOT", "dataset")


def _list_path(root: str, dataset: str, split: str) -> str:
    return os.path.join(root, dataset, f"{dataset}_{split}_list.txt")


def _make_dataset(root, dataset, split, spec, synthetic_len, resize_hw=None,
                  seed=0, synthetic_hw=None):
    if os.path.exists(_list_path(root, dataset, split)):
        return ManifestDataset.from_list_file(
            _list_path(root, dataset, split), spec,
            root=os.path.join(root, dataset), resize_hw=resize_hw), True
    print(f"[esn_tpu_torch.data] WARNING: no list file for "
          f"{dataset}/{split} under {root!r}: using synthetic data")
    return SyntheticDataset(spec, length=synthetic_len, seed=seed,
                            hw=resize_hw or synthetic_hw or spec.source_hw
                            ), False


def _inform(root, dataset, spec, train_ds, real):
    path = os.path.join(root, "inform", f"{dataset}_inform.pkl") \
        if real else None
    return load_or_compute_inform(path, train_ds.stats_samples,
                                  spec.num_classes, spec.ignore_label)


def build_dataset_train(dataset: str, input_size: Tuple[int, int],
                        batch_size: int, train_type: str = "train",
                        random_scale: bool = True, random_mirror: bool = True,
                        aug_mode: str = "batch",
                        num_workers: int = 4, root: str = DEFAULT_ROOT,
                        synthetic_len: int = 64,
                        val_size: Optional[Tuple[int, int]] = None,
                        synthetic_hw: Optional[Tuple[int, int]] = None):
    """Returns ``(datas, train_loader, val_loader, augment,
    eval_transform)``; ``datas`` = {'classWeights', 'mean', 'std'}.
    ``val_size`` fixes the val resolution (default: the source's)."""
    spec = get_spec(dataset)
    split = "trainval" if train_type == "trainval" else "train"
    train_ds, real = _make_dataset(root, dataset, split, spec, synthetic_len,
                                   synthetic_hw=synthetic_hw)
    val_ds, _ = _make_dataset(root, dataset, "val", spec,
                              max(synthetic_len // 4, 8), seed=1,
                              resize_hw=val_size, synthetic_hw=synthetic_hw)
    datas = _inform(root, dataset, spec, train_ds, real)

    train_loader = BatchLoader(train_ds, batch_size, shuffle=True,
                               drop_last=True, num_workers=num_workers)
    val_loader = BatchLoader(val_ds, batch_size, shuffle=False,
                             drop_last=False, num_workers=num_workers)

    if isinstance(train_ds, SyntheticDataset):
        source_hw = train_ds.hw
    else:
        # real data: the first record sets the one source shape, and odd
        # records are resized to it
        source_hw = tuple(train_ds[0]["image"].shape[:2])
        train_ds.resize_hw = source_hw

    augment = make_augment_fn(
        crop_hw=tuple(input_size), source_hw=source_hw,
        mean=datas["mean"], ignore_label=spec.ignore_label,
        random_scale=random_scale, random_mirror=random_mirror,
        per_image_scale=(aug_mode == "reference"))
    return (datas, train_loader, val_loader, augment,
            make_eval_transform(mean=datas["mean"]))


def build_dataset_test(dataset: str, num_workers: int = 4,
                       none_gt: bool = False, root: str = DEFAULT_ROOT,
                       batch_size: int = 1, synthetic_len: int = 16,
                       synthetic_hw: Optional[Tuple[int, int]] = None):
    """Returns ``(datas, test_loader, eval_transform)``; ``none_gt``
    selects the unlabeled test split (predict)."""
    spec = get_spec(dataset)
    split = "test" if none_gt else "val"
    ds, _ = _make_dataset(root, dataset, split, spec, synthetic_len,
                          seed=2, synthetic_hw=synthetic_hw)
    if isinstance(ds, SyntheticDataset) and none_gt:
        ds.with_labels = False
    train_ds, train_real = _make_dataset(root, dataset, "train", spec,
                                         synthetic_len,
                                         synthetic_hw=synthetic_hw)
    datas = _inform(root, dataset, spec, train_ds, train_real)
    loader = BatchLoader(ds, batch_size, shuffle=False, drop_last=False,
                         num_workers=num_workers)
    return datas, loader, make_eval_transform(mean=datas["mean"])
