"""The readings a cell's limits are set from, in one process on the card.

    python3 -m perfbench.tools.readings --workload NAME [--sound 12]
        [--control 3] [--faults 3] [--fault NAME ...] [--dtype float32]
        [--seconds 2] [--first-seed N] [--out FILE]

- sound: the cell's own run (its driver, a short window at the cell's
  load) on ``--sound`` seeds: the numbers the comparison reads, with no
  fault.
- control: the reference put in the program's place, computed in float8
  (values e4m3, gradients e5m2: the precision below the configuration's
  bfloat16; ``reference/layers.py`` ``Numerics``), judged by the same
  comparison against the f32 reference, on ``--control`` seeds.
- faults: the cell's run with each fault of ``perfbench/faults.py`` that
  its route can have planted under the timed path (or those named by
  ``--fault``), on ``--faults`` seeds.

``--dtype`` runs the program in another compute dtype than the
configuration states (``float32``: the program's own f32 path, with TF32
off as in the reference, a witness of where a gap comes from); such runs
set no limit.

Prints one JSON object (and writes it to ``--out``): each seed's
numbers, and per number the largest sound reading, the smallest control
reading and the smallest reading of each fault.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Dict, List

NUMBERS = {"predict": ("map_gap_max", "map_mismatch"),
           "train": ("loss_gap", "loss_gap_first", "grad_gap",
                     "grad_gap_median", "change_gap", "change_gap_median")}


def control_predict(cell, seed, device):
    import torch
    from perfbench.drivers import predict as D
    from perfbench.reference import layers as L
    ref_mod, _, weights, images, _ = D.prepare(cell, seed, device)
    classes = cell.config["classes"]
    ref = ref_mod.build(classes).to(device)
    ref.load_state_dict(weights)
    low = ref_mod.build(classes).to(device)
    low.load_state_dict(weights)
    low.eval()
    L.set_numerics(low, L.Numerics("fp8"))
    chunk = cell.traffic["reference_chunk"]
    maps = {}
    with torch.no_grad():
        for slot, x in enumerate(images):
            maps[slot] = torch.cat([low(x[i:i + chunk]).argmax(1)
                                    .to(torch.int32)
                                    for i in range(0, x.shape[0], chunk)])
    return D.judge(cell, ref, images, maps)


def control_train(cell, seed, device):
    from perfbench.drivers import train as D
    from perfbench.reference import layers as L
    p = D.prepare(cell, seed, device)
    classes = cell.config["classes"]
    ref = p["ref_mod"].build(classes).to(device)
    ref.load_state_dict(p["weights"])
    exact = D.reference_steps(cell, p, ref)
    del ref
    low = p["ref_mod"].build(classes).to(device)
    low.load_state_dict(p["weights"])
    L.set_numerics(low, L.Numerics("fp8"))
    got = D.reference_steps(cell, p, low)
    return D.gaps(got, exact)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--dtype", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch
    from perfbench import bench, faults
    from perfbench.run import cache_environment
    cache_environment()
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = bench.find_cell(args.workload)
    if args.dtype:
        cell.config = dict(cell.config, compute_dtype=args.dtype)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    driver = bench.driver_module(cell.route)
    numbers = NUMBERS[cell.route]
    notes: List[str] = []
    out: Dict = {"workload": cell.name, "device":
                 torch.cuda.get_device_name(device),
                 "compute_dtype": cell.config["compute_dtype"], "sound": [],
                 "control": [], "faults": {}}
    seed = args.first_seed

    def one(fault=None):
        nonlocal seed
        seed += 1
        t0 = time.perf_counter()
        res = driver.run(cell, seed, args.seconds, False, device, t0,
                         notes.append, fault=fault)
        row = {"seed": seed, **res["diagnostics"],
               "correct": res["correct"], **res["e2e"],
               "setup_s": res["setup_s"]}
        torch.cuda.empty_cache()
        return row

    for _ in range(args.sound):
        out["sound"].append(one())
    control = control_predict if cell.route == "predict" else control_train
    for _ in range(args.control):
        seed += 1
        row = control(cell, seed, device)
        out["control"].append({"seed": seed, **row})
        torch.cuda.empty_cache()
    for name, fault in faults.BY_ROUTE[cell.route].items():
        if not args.fault or name in args.fault:
            out["faults"][name] = [one(fault) for _ in range(args.faults)]

    def vals(rows, k):
        return [r[k] for r in rows if isinstance(r.get(k), (int, float))]

    def lo(rows, k):
        return min(vals(rows, k), default=math.nan)

    def hi(rows, k):
        return max(vals(rows, k), default=math.nan)

    out["summary"] = {
        k: {"sound_max": hi(out["sound"], k),
            "control_min": lo(out["control"], k),
            **{f"{f}_min": lo(rows, k) for f, rows in out["faults"].items()}}
        for k in numbers}
    out["notes"] = notes[-60:]
    text = json.dumps(out, indent=1, default=str)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps(out["summary"], indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
