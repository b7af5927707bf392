"""Pack a manifest dataset into raw ``.npy`` records for codec-free loading
(counterpart of ``tools/pack_dataset.py``, on the port's decoder: no jax,
no cv2).

Each (image, label) pair becomes one contiguous ``(H, W, 4)`` uint8
``.npy`` (BGR in channels 0-2, the label in 3), an unlabelled record
``(H, W, 3)``; ``ManifestDataset._get_packed`` reads them. The packed root
keeps the list-file layout (``<out>/<ds>/<ds>_<split>_list.txt`` naming
``packed/<split>_<stem>.npy``), so every CLI takes it as ``--data_root``:

    python -m esn_tpu_torch.tools.pack_dataset --dataset camvid \\
        --root dataset [--out dataset_packed] [--splits train,val,test] \\
        [--workers N]

Records decode on ``--workers`` threads (the decoder releases the GIL).
Labels must fit uint8 (trainIDs do: Cityscapes ignore 255, CamVid 11).
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from ..data.datasets import ManifestDataset, get_spec, read_manifest


def _record(item) -> np.ndarray:
    if "label" not in item:
        return item["image"]
    lab = item["label"]
    if lab.max() > 255:
        raise ValueError(f"label of {item['name']} exceeds uint8")
    return np.concatenate([item["image"], lab.astype(np.uint8)[..., None]],
                          axis=-1)


def pack_split(root: str, out_root: str, dataset: str, split: str,
               workers: int = 1) -> Optional[int]:
    """Pack one split; None where the split has no list file."""
    list_path = os.path.join(root, dataset, f"{dataset}_{split}_list.txt")
    if not os.path.exists(list_path):
        return None
    ds = ManifestDataset(read_manifest(list_path, os.path.join(root, dataset)),
                         get_spec(dataset))
    out_ds = os.path.join(out_root, dataset)
    os.makedirs(os.path.join(out_ds, "packed"), exist_ok=True)

    def pack(i: int) -> str:
        item = ds[i]
        stem = os.path.splitext(item["name"])[0]
        rel = os.path.join("packed", f"{split}_{stem}.npy")
        np.save(os.path.join(out_ds, rel),
                np.ascontiguousarray(_record(item)))
        return rel

    with ThreadPoolExecutor(max(1, workers)) as pool:
        lines: List[str] = list(pool.map(pack, range(len(ds))))
    with open(os.path.join(out_ds, f"{dataset}_{split}_list.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--root", default="dataset")
    ap.add_argument("--out", default=None,
                    help="packed root (default: <root>_packed)")
    ap.add_argument("--splits", default="train,val,trainval,test")
    ap.add_argument("--workers", type=int,
                    default=max(1, min(8, os.cpu_count() or 1)))
    args = ap.parse_args(argv)
    out_root = args.out or args.root.rstrip("/") + "_packed"
    total = 0
    for split in args.splits.split(","):
        n = pack_split(args.root, out_root, args.dataset, split,
                       args.workers)
        if n is None:
            print(f"{split}: no list file, skipped")
        else:
            print(f"{split}: packed {n} records")
            total += n
    # the inform pickle is recomputed from the packed records on first use
    # (the same statistics: the records hold the decoded pixels); copy one
    # that exists
    src = os.path.join(args.root, "inform", f"{args.dataset}_inform.pkl")
    if os.path.exists(src):
        os.makedirs(os.path.join(out_root, "inform"), exist_ok=True)
        shutil.copy2(src, os.path.join(out_root, "inform",
                                       f"{args.dataset}_inform.pkl"))
        print("copied inform pickle")
    print(f"packed {total} records under {out_root}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
