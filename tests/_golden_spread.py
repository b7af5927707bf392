"""The reference's spread over seeds of its four golden runs, and the
bound that the port's golden runs are held to.

    JAX_PLATFORMS=cpu python tests/_golden_spread.py [--seeds 2 3 ... 8]
        [--reuse]

Runs ``tools/golden_run.run_one`` for every config at each seed, one
process a seed (all started together), on the reference's golden platform
(8 virtual CPU devices); ``CONFIGS`` is changed in memory only. Seed 1 is
``GOLDEN.json``'s. Writes ``esn_tpu_torch/tools/golden_spread.json``: the
runs, the command, the jax version, each config's bound from seeds 1-4
(``esn_tpu_torch.tools.golden_run.spread_bounds``: the ranges, and the
mIoU floor) and what the held-out seeds make of it. Also the first rule,
stated before any port run was compared: the same ranges, and every class
nonzero at every one of seeds 1-4 nonzero, which the held-out seeds broke.
``--reuse`` takes the runs already in ``golden_spread.json`` instead of
running.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULE_SEEDS = (1, 2, 3, 4)


def run_seed(seed: int, out: str) -> None:
    """One process: every config at ``seed``, written to ``out``."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tools import golden_run as g
    record = {"jax_version": jax.__version__, "seed": seed, "results": {}}
    with tempfile.TemporaryDirectory() as tmp:
        root = g.build_fixture(os.path.join(tmp, "ds"))
        for name in g.CONFIGS:
            g.CONFIGS[name] = dict(g.CONFIGS[name], seed=seed)
            t0 = time.time()
            r = g.run_one(name, root, os.path.join(tmp, "ckpt", name))
            r["seconds"] = time.time() - t0
            record["results"][name] = r
            print(name, seed, r["miou"], r["seconds"], flush=True)
            with open(out, "w") as f:
                json.dump(record, f, indent=1)


def first_rule_check(port, result, bound, nonzero):
    bad = port.check(result, bound)
    zero = [c for c in nonzero if not result["per_class_iou"][c] > 0]
    if zero:
        bad.append(f"classes {zero} have IoU 0 (nonzero at every seed)")
    return bad


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, nargs="+",
                        default=[2, 3, 4, 5, 6, 7, 8])
    parser.add_argument("--reuse", action="store_true")
    parser.add_argument("--one", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--to", default="", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one is not None:
        run_seed(args.one, args.to)
        return
    sys.path.insert(0, REPO)
    from esn_tpu_torch.tools import golden_run as port
    with open(os.path.join(REPO, "GOLDEN.json")) as f:
        golden = json.load(f)
    seeds = {1: golden["results"]}
    jax_versions = {golden["jax_version"]}
    if args.reuse:
        old = port.load_spread()
        seeds.update({int(s): r for s, r in old["seeds"].items()
                      if s != "1"})
        jax_versions.update(old["jax_version"])
        command = old["command"]
    else:
        work = tempfile.mkdtemp()
        procs = [subprocess.Popen([sys.executable, __file__, "--one", str(s),
                                   "--to", os.path.join(work,
                                                        f"seed{s}.json")])
                 for s in args.seeds]
        if any(p.wait() for p in procs):
            raise SystemExit("a seed's run failed")
        for s in args.seeds:
            with open(os.path.join(work, f"seed{s}.json")) as f:
                rec = json.load(f)
            seeds[s] = rec["results"]
            jax_versions.add(rec["jax_version"])
        command = ("JAX_PLATFORMS=cpu python tests/_golden_spread.py "
                   "--seeds " + " ".join(map(str, args.seeds)))
    names = list(golden["results"])
    bounds, held_out, first = {}, {}, {}
    for name in names:
        runs = {s: seeds[s][name] for s in seeds}
        rule = [runs[s] for s in RULE_SEEDS]
        bounds[name] = port.spread_bounds(rule)
        held_out[name] = {str(s): port.check(r, bounds[name])
                          for s, r in runs.items() if s not in RULE_SEEDS}
        nonzero = np.all([np.asarray(r["per_class_iou"]) > 0 for r in rule],
                         0)
        nonzero = [int(c) for c in np.flatnonzero(nonzero)]
        first[name] = {"nonzero_classes": nonzero, "held_out": {
            str(s): first_rule_check(port, r, bounds[name], nonzero)
            for s, r in runs.items() if s not in RULE_SEEDS}}
    payload = {
        "command": command,
        "jax_version": sorted(jax_versions),
        "platform": golden["platform"],
        "fixture": golden["fixture"],
        "rule": ("per config, from the reference's runs at seeds "
                 f"{list(RULE_SEEDS)}: a run's final mIoU, and its mean "
                 "loss over the last quarter of epochs, each within the "
                 "seeds' range widened on each side by the range's width "
                 f"(at least {port.MIN_WIDEN}), and its mIoU at least "
                 f"{port.MIOU_FLOOR}"),
        "seeds": {str(s): ("GOLDEN.json" if s == 1 else seeds[s])
                  for s in sorted(seeds)},
        "bounds": bounds,
        "held_out": held_out,
        "first_rule": {
            "rule": ("the same ranges from seeds 1-4, no floor, and every "
                     "class with nonzero IoU at every one of them nonzero"),
            "configs": first},
    }
    with open(port.SPREAD_PATH, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps({"bounds": bounds, "held_out": held_out,
                      "first_rule_held_out": {
                          n: v["held_out"] for n, v in first.items()}},
                     indent=1))


if __name__ == "__main__":
    main()
