"""The four golden training runs through the port (counterpart of
``tools/golden_run.py``).

``GOLDEN.json`` pins the reference's final mIoU and loss curves of four
tiny real-PNG trainings (ENet, Fast-SCNN, ENet with OHEM, ERFNet) on a
CamVid-like fixture of 8 train and 4 val items at 96x128. This tool writes
the same fixture as PNG files (``data/png.py``), reads it back through
``ManifestDataset`` and the port's decoder, and trains each config with the
port's ``Trainer``: the port's own init and augmentation and dropout
streams, so the curves are not the reference's. A config is held instead
to the reference's own spread over seeds (``golden_spread.json``, written
by ``tests/_golden_spread.py``). The bound of one run:

- the final mIoU within the range of the reference's seeds 1-4, widened
  on each side by that range's width (at least 0.02), and at least
  ``MIOU_FLOOR``;
- the mean loss over the last quarter of epochs within a range built the
  same way.

The port runs each config at ``SEEDS``; a majority of its runs must meet
the bound (one run is one draw of a chaotic training: f32 rounding alone
moves it). bf16 on the card is held to the same bound, and the gap
between its median and f32's over ``SEEDS`` to ``BF16_GAP``.

The port's results on the CPU (f32, one torch thread a run) are pinned in
``golden_torch.json``.

    python -m esn_tpu_torch.tools.golden_run [--device cuda|cpu]
        [--dtype float32|bfloat16] [--configs enet,...] [--seeds 1,2,3]
        [--plant lr0|mirrored_labels] [--processes] [--write] [--out PATH]

It runs on the card (``--device cuda``, the default; with no card it
raises, as ``cli.train`` does) unless asked for the CPU with ``--device
cpu``. ``--processes`` runs each seed in a CPU process of its own (one
torch thread each, all started together). ``--plant`` trains with a
fault planted, to show that the bound can fail: ``lr0`` a learning rate
of 0, ``mirrored_labels`` the train labels mirrored left to right and
their images not. ``--device cpu --write`` re-pins ``golden_torch.json``
(CPU, float32). On the card float32 runs with TF32 off. ``--out`` also
records the kernel launches of the process's runs (``launches``). Exits
non-zero when a config breaks its bound.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SPREAD_PATH = os.path.join(HERE, "golden_spread.json")
PIN_PATH = os.path.join(HERE, "golden_torch.json")

# the reference's fixture and configs (tools/golden_run.py)
SRC_HW = (96, 128)
TRAIN_N, VAL_N = 8, 4
FIXTURE_SEED = 11
CONFIGS = {
    "enet": dict(model="ENet", dataset="camvid", input_size=(96, 128),
                 max_epochs=40, batch_size=4, lr=2e-2, val_epochs=40,
                 random_scale=True, random_mirror=True, num_workers=0,
                 seed=1),
    "fastscnn": dict(model="FastSCNN", dataset="camvid",
                     input_size=(96, 128), max_epochs=24, batch_size=4,
                     lr=2e-2, val_epochs=24, random_scale=True,
                     random_mirror=True, num_workers=0, seed=1),
    "enet_ohem": dict(model="ENet", dataset="camvid", input_size=(96, 128),
                      max_epochs=40, batch_size=4, lr=2e-2, val_epochs=40,
                      loss="ohem", random_scale=True, random_mirror=True,
                      num_workers=0, seed=1),
    "erfnet": dict(model="ERFNet", dataset="camvid", input_size=(96, 128),
                   max_epochs=72, batch_size=4, lr=1e-2, val_epochs=72,
                   random_scale=True, random_mirror=True, num_workers=0,
                   seed=1),
}
MIN_WIDEN = 0.02
# between the planted faults' mIoU (at most 0.028, PERF.md) and the
# reference's smallest over seeds 1-8 (0.128, golden_spread.json)
MIOU_FLOOR = 0.07
SEEDS = (1, 2, 3)
PLANTS = ("lr0", "mirrored_labels")
# bf16 against f32 on the card: the largest gap allowed between the
# medians over SEEDS, per config: the largest one-seed gap at seeds 1-6
# on the H100 (golden_run.run_seeds there, PERF.md "bf16 against f32")
BF16_GAP = {"enet": {"miou": 0.1454, "tail_loss": 0.5213},
            "fastscnn": {"miou": 0.1908, "tail_loss": 0.0900},
            "enet_ohem": {"miou": 0.0975, "tail_loss": 0.3021},
            "erfnet": {"miou": 0.2365, "tail_loss": 0.1395}}


def fixture_items():
    """The reference's fixture: ``(split, index, image, label)`` of a
    CamVid-like 11-class band dataset, the images (BGR) from
    ``RandomState(11)``."""
    rng = np.random.RandomState(FIXTURE_SEED)
    h, w = SRC_HW
    for split, n in (("train", TRAIN_N), ("val", VAL_N)):
        for i in range(n):
            lab = np.tile((np.arange(w) // 12 % 11).astype(np.uint8), (h, 1))
            img = (lab[..., None] * 18
                   + rng.randint(0, 30, (h, w, 3))).astype(np.uint8)
            yield split, i, img, lab


def build_fixture(root: str) -> str:
    """The reference's fixture under ``root``. ``write_png`` stores RGB,
    so the channels are swapped: the decoded BGR pixels equal those of the
    reference's ``cv2.imwrite`` files."""
    from ..data.png import write_png
    ds = os.path.join(root, "camvid")
    os.makedirs(os.path.join(ds, "images"), exist_ok=True)
    lines = {"train": [], "val": []}
    for split, i, img, lab in fixture_items():
        ip, lp = f"images/{split}_{i}.png", f"images/{split}_{i}_L.png"
        write_png(os.path.join(ds, ip), img[..., ::-1])
        write_png(os.path.join(ds, lp), lab)
        lines[split].append(f"{ip} {lp}")
    for split, rows in lines.items():
        with open(os.path.join(ds, f"camvid_{split}_list.txt"), "w") as f:
            f.write("\n".join(rows))
    return root


class MirroredLabels:
    """A dataset whose labels are mirrored left to right, its images not."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        item = dict(self.dataset[i])
        item["label"] = np.ascontiguousarray(item["label"][:, ::-1])
        return item


def run_one(name: str, data_root: str, savedir: str, *, device: str = "cpu",
            dtype: Optional[str] = None, plant: Optional[str] = None,
            **overrides) -> Dict:
    """Train config ``name`` with the port's Trainer: the loss of each
    epoch, the final mIoU and the per-class IoU, and the seconds taken.
    ``dtype`` None is float32 on the CPU and bfloat16 on the card; on
    the card float32 runs with TF32 off. ``plant`` one of ``PLANTS``;
    ``overrides`` change config fields (``seed``)."""
    import torch
    from ..train.trainer import TrainConfig, Trainer
    if plant not in (None,) + PLANTS:
        raise ValueError(f"plant {plant!r}: one of {PLANTS}")
    if plant == "lr0":
        overrides["lr"] = 0.0
    cfg = TrainConfig(data_root=data_root, savedir=savedir, device=device,
                      compute_dtype=dtype, **dict(CONFIGS[name], **overrides))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        tr = Trainer(cfg)
        if plant == "mirrored_labels":
            tr.train_loader.dataset = MirroredLabels(tr.train_loader.dataset)
        losses = [float(tr.train_epoch(e)[0]) for e in range(cfg.max_epochs)]
        iou, miou = tr.validate()
        seconds = time.perf_counter() - t0
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return {"seed": cfg.seed, "losses": losses, "miou": float(miou),
            "per_class_iou": [round(float(v), 6) for v in iou],
            "seconds": seconds}


def run_seeds(name: str, data_root: str, savedir: str,
              seeds: Sequence[int] = SEEDS, *, device: str = "cpu",
              dtype: Optional[str] = None, plant: Optional[str] = None,
              processes: bool = False) -> List[Dict]:
    """``run_one`` at each seed: in this process one after another, or
    (``processes``, CPU) one process a seed with one torch thread, all
    started together."""
    if not processes:
        return [run_one(name, data_root, os.path.join(savedir, f"s{s}"),
                        device=device, dtype=dtype, plant=plant, seed=s)
                for s in seeds]
    if device != "cpu":
        raise ValueError("processes: CPU runs only")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    outs = [os.path.join(savedir, f"s{s}.json") for s in seeds]
    os.makedirs(savedir, exist_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "esn_tpu_torch.tools.golden_run",
         "--device", "cpu",
         "--configs", name, "--seeds", str(s), "--data_root", data_root,
         "--savedir", os.path.join(savedir, f"s{s}"), "--threads", "1",
         "--dtype", dtype or "float32", "--out", out]
        + (["--plant", plant] if plant else []),
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for s, out in zip(seeds, outs)]
    logs = [p.communicate()[0] for p in procs]
    runs = []
    for out, log in zip(outs, logs):
        if not os.path.exists(out):
            raise RuntimeError(f"a golden run wrote no {out}:\n{log[-3000:]}")
        with open(out) as f:
            runs.extend(json.load(f)["results"][name])
    return runs


def tail_loss(losses: List[float]) -> float:
    """The mean loss over the last quarter of the epochs."""
    q = max(1, len(losses) // 4)
    return float(np.mean(losses[-q:]))


def _widened(values) -> List[float]:
    lo, hi = float(min(values)), float(max(values))
    pad = max(hi - lo, MIN_WIDEN)
    return [lo - pad, hi + pad]


def spread_bounds(runs: List[Dict]) -> Dict:
    """The bound of one config from the reference's runs at several seeds
    (each ``{"losses", "miou"}``)."""
    return {"miou": _widened([r["miou"] for r in runs]),
            "tail_loss": _widened([tail_loss(r["losses"]) for r in runs]),
            "miou_floor": MIOU_FLOOR}


def check(result: Dict, bound: Dict) -> List[str]:
    """What of ``bound`` the run ``result`` breaks (empty: none)."""
    bad = []
    lo, hi = bound["miou"]
    if not lo <= result["miou"] <= hi:
        bad.append(f"mIoU {result['miou']:.4f} outside [{lo:.4f}, {hi:.4f}]")
    if not result["miou"] >= bound["miou_floor"]:
        bad.append(f"mIoU {result['miou']:.4f} under the floor "
                   f"{bound['miou_floor']}")
    lo, hi = bound["tail_loss"]
    tl = tail_loss(result["losses"])
    if not (np.isfinite(tl) and lo <= tl <= hi):
        bad.append(f"last-quarter loss {tl:.4f} outside [{lo:.4f}, {hi:.4f}]")
    return bad


def check_runs(runs: List[Dict], bound: Dict) -> List[str]:
    """Empty when a majority of ``runs`` (one config at several seeds)
    meet ``bound``; else every failing run's breaks."""
    bad = [check(r, bound) for r in runs]
    if sum(not b for b in bad) > len(runs) // 2:
        return []
    return [f"seed {r['seed']}: " + "; ".join(b)
            for r, b in zip(runs, bad) if b]


def medians(runs: List[Dict]) -> Dict[str, float]:
    """The median over ``runs`` of the final mIoU and last-quarter loss."""
    return {"miou": float(np.median([r["miou"] for r in runs])),
            "tail_loss": float(np.median([tail_loss(r["losses"])
                                          for r in runs]))}


def check_gap(low: List[Dict], f32: List[Dict], limit: Dict) -> List[str]:
    """bf16 against f32 (``low``, ``f32``: one config's runs at the same
    seeds): the gap between their medians within ``limit``."""
    a, b = medians(low), medians(f32)
    return [f"{what} median gap {abs(a[what] - b[what]):.4f} above "
            f"{limit[what]}" for what in ("miou", "tail_loss")
            if not abs(a[what] - b[what]) <= limit[what]]


def load_spread() -> Dict:
    with open(SPREAD_PATH) as f:
        return json.load(f)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (the default) or cpu")
    parser.add_argument("--dtype", default=None,
                        choices=("float32", "bfloat16"))
    parser.add_argument("--configs", default=",".join(CONFIGS))
    parser.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    parser.add_argument("--plant", default=None, choices=PLANTS)
    parser.add_argument("--processes", action="store_true",
                        help="one CPU process a seed, one thread each")
    parser.add_argument("--threads", type=int, default=0,
                        help="torch threads (0: torch's default)")
    parser.add_argument("--data_root", default="",
                        help="an existing fixture (default: a new one)")
    parser.add_argument("--savedir", default="")
    parser.add_argument("--write", action="store_true",
                        help="re-pin golden_torch.json (CPU float32)")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    import torch

    from ..ops import kernels as K
    names = [n for n in args.configs.split(",") if n]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    if args.write:
        if (args.device != "cpu" or args.dtype not in (None, "float32")
                or args.plant):
            parser.error("--write pins the CPU's float32 runs")
        args.processes = True
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; run on the CPU with --device cpu")
    if args.threads:
        torch.set_num_threads(args.threads)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = args.data_root or build_fixture(os.path.join(tmp, "ds"))
        for name in names:
            results[name] = run_seeds(
                name, root, os.path.join(args.savedir or tmp, "ckpt", name),
                seeds, device=args.device, dtype=args.dtype,
                plant=args.plant, processes=args.processes)
    bounds = load_spread()["bounds"]
    failed = {n: check_runs(r, bounds[n]) for n, r in results.items()}
    payload = {"torch_version": torch.__version__,
               "cpu_capability": torch.backends.cpu.get_cpu_capability(),
               "device": args.device, "dtype": args.dtype or (
                   "float32" if args.device == "cpu" else "bfloat16"),
               "threads": 1 if args.processes else torch.get_num_threads(),
               "plant": args.plant,
               "fixture": {"src_hw": list(SRC_HW), "train_n": TRAIN_N,
                           "val_n": VAL_N, "rng_seed": FIXTURE_SEED},
               "results": results, "bound_failures": failed,
               "launches": dict(K.LAUNCHES)}
    if args.write:
        with open(PIN_PATH, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {PIN_PATH}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
    for name, runs in results.items():
        for r in runs:
            bad = check(r, bounds[name])
            print(f"{name} seed {r['seed']}: mIoU {r['miou']:.4f} "
                  f"last-quarter loss {tail_loss(r['losses']):.4f} "
                  f"({r['seconds']:.1f} s) "
                  + ("within the bound" if not bad else "; ".join(bad)))
        print(f"{name}: " + ("a majority within the bound"
                             if not failed[name] else "breaks its bound"))
    return 1 if any(failed.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
