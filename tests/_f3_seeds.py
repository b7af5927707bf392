"""F3 (ROADMAP Queue 3): does the port's ENet train to a lower golden mIoU
than the reference's? Runs both packages' golden ENet configs at more seeds
and applies the test fixed in PERF.md before the readings.

    python tests/_f3_seeds.py run --out DIR [--jobs 8]
        [--ref-seeds 1,17-40] [--port-seeds 9-40]
    python tests/_f3_seeds.py analyze --out DIR

``run`` trains ``enet`` and ``enet_ohem`` (f32, CPU) at each seed, one
process a seed and package, ``--jobs`` at a time: the reference through
``tools/golden_run.run_one`` on its golden platform (8 virtual CPU
devices, as ``tests/_golden_spread.py`` runs it), the port through
``python -m esn_tpu_torch.tools.golden_run --device cpu`` on one torch
thread. Each run's record goes to ``DIR/{ref,port}_s{seed}.json``; a
record already there is kept. The reference's seed 1 is a control, read
beside ``GOLDEN.json``'s (an f32 golden run is chaotic: another host or
thread count moves it by a few hundredths of mIoU).

``analyze`` pools the new runs with the readings the repo holds (the
reference's seeds 1-8 from ``GOLDEN.json`` and ``golden_spread.json``,
the port's seeds 1-3 from ``golden_torch.json``) and prints, per config,
each package's mean final mIoU, its standard deviation and how many runs
end with an edge class (0 or 10) at IoU 0, Welch's t of the port's mean
less the reference's and Fisher's exact two-sided p on the edge-class
counts, and the verdict: the gap is real if t < -2.0 or p < 0.05 in
either config. Writes ``DIR/f3.json``; ``tests/_f3_seeds.json`` is that
report of the run PERF.md records (seeds 17-40, PR 16).
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("enet", "enet_ohem")
EDGE = (0, 10)
T_LIMIT, P_LIMIT = -2.0, 0.05


def _seeds(text):
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def ref_one(seed, out):
    """One process: the reference's configs at ``seed``, to ``out``."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tools import golden_run as g
    record = {"jax_version": jax.__version__, "seed": seed, "results": {}}
    with tempfile.TemporaryDirectory() as tmp:
        root = g.build_fixture(os.path.join(tmp, "ds"))
        for name in CONFIGS:
            g.CONFIGS[name] = dict(g.CONFIGS[name], seed=seed)
            t0 = time.time()
            r = g.run_one(name, root, os.path.join(tmp, "ckpt", name))
            r.update(seed=seed, seconds=time.time() - t0)
            record["results"][name] = [r]
    with open(out, "w") as f:
        json.dump(record, f, indent=1)


def _task(kind, seed, out, fixture):
    if kind == "ref":
        cmd = [sys.executable, os.path.abspath(__file__), "ref-one",
               str(seed), out]
    else:
        cmd = [sys.executable, "-m", "esn_tpu_torch.tools.golden_run",
               "--device", "cpu", "--configs", ",".join(CONFIGS),
               "--seeds", str(seed), "--threads", "1", "--data_root",
               fixture, "--out", out]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.time()
    p = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True)
    if not os.path.exists(out):
        raise RuntimeError(f"{kind} seed {seed} wrote nothing:\n"
                           f"{p.stdout[-2000:]}{p.stderr[-2000:]}")
    print(f"{kind} seed {seed}: {time.time() - t0:.0f} s", flush=True)


def run(args):
    sys.path.insert(0, REPO)
    from esn_tpu_torch.tools.golden_run import build_fixture
    os.makedirs(args.out, exist_ok=True)
    tasks = [("ref", s) for s in _seeds(args.ref_seeds)] \
        + [("port", s) for s in _seeds(args.port_seeds)]
    with tempfile.TemporaryDirectory() as tmp:
        fixture = build_fixture(os.path.join(tmp, "ds"))
        with ThreadPoolExecutor(args.jobs) as pool:
            futures = [pool.submit(_task, k, s,
                                   os.path.join(args.out, f"{k}_s{s}.json"),
                                   fixture)
                       for k, s in tasks
                       if not os.path.exists(os.path.join(args.out,
                                                          f"{k}_s{s}.json"))]
            for f in futures:
                f.result()


def _load(path):
    with open(path) as f:
        return json.load(f)


def pooled(out):
    """{package: {config: {seed: run}}} of the new runs and the repo's."""
    runs = {"ref": {c: {} for c in CONFIGS}, "port": {c: {} for c in CONFIGS}}
    golden = _load(os.path.join(REPO, "GOLDEN.json"))["results"]
    spread = _load(os.path.join(REPO, "esn_tpu_torch", "tools",
                                "golden_spread.json"))["seeds"]
    pin = _load(os.path.join(REPO, "esn_tpu_torch", "tools",
                             "golden_torch.json"))["results"]
    for c in CONFIGS:
        runs["ref"][c][1] = golden[c]
        for s, rec in spread.items():
            if isinstance(rec, dict):
                runs["ref"][c][int(s)] = rec[c]
        for r in pin[c]:
            runs["port"][c][int(r["seed"])] = r
    for name in sorted(os.listdir(out)):
        kind, _, rest = name.partition("_s")
        if kind not in runs or not rest.endswith(".json"):
            continue
        rec = _load(os.path.join(out, name))
        for c in CONFIGS:
            for r in rec["results"][c]:
                seed = int(r["seed"])
                if kind == "ref" and seed == 1:
                    continue            # the control, read in analyze
                runs[kind][c].setdefault(seed, r)
    return runs


def analyze(args):
    from scipy import stats
    runs = pooled(args.out)
    report = {"test": f"real if Welch t < {T_LIMIT} or Fisher p < "
                      f"{P_LIMIT} in either config", "configs": {}}
    control = os.path.join(args.out, "ref_s1.json")
    if os.path.exists(control):
        golden = _load(os.path.join(REPO, "GOLDEN.json"))["results"]
        got = _load(control)["results"]
        report["control_seed1"] = {
            c: {"miou": got[c][0]["miou"], "golden": golden[c]["miou"]}
            for c in CONFIGS}
    real = False
    for c in CONFIGS:
        row = {}
        for kind in ("port", "ref"):
            rs = runs[kind][c]
            miou = np.array([rs[s]["miou"] for s in sorted(rs)])
            edge = sum(any(rs[s]["per_class_iou"][e] == 0 for e in EDGE)
                       for s in sorted(rs))
            row[kind] = {"n": len(rs), "seeds": sorted(rs),
                         "mean": float(miou.mean()),
                         "sd": float(miou.std(ddof=1)),
                         "edge_zero": int(edge),
                         "miou": [round(float(v), 4) for v in miou]}
        t = stats.ttest_ind([runs["port"][c][s]["miou"]
                             for s in runs["port"][c]],
                            [runs["ref"][c][s]["miou"]
                             for s in runs["ref"][c]], equal_var=False)
        p, r = row["port"], row["ref"]
        _, fisher = stats.fisher_exact(
            [[p["edge_zero"], p["n"] - p["edge_zero"]],
             [r["edge_zero"], r["n"] - r["edge_zero"]]])
        row.update(welch_t=float(t.statistic), welch_p=float(t.pvalue),
                   fisher_p=float(fisher))
        row["real"] = bool(t.statistic < T_LIMIT or fisher < P_LIMIT)
        real |= row["real"]
        report["configs"][c] = row
        print(f"{c}: port {p['mean']:.4f} (sd {p['sd']:.4f}, n {p['n']}, "
              f"edge at 0 in {p['edge_zero']}) ref {r['mean']:.4f} "
              f"(sd {r['sd']:.4f}, n {r['n']}, edge at 0 in "
              f"{r['edge_zero']}): Welch t {row['welch_t']:.3f}, Fisher p "
              f"{fisher:.4f} -> {'real' if row['real'] else 'noise'}")
    report["real"] = real
    if "control_seed1" in report:
        print("control, the reference's seed 1:", report["control_seed1"])
    print("F3:", "the gap is real" if real else "no real gap")
    with open(os.path.join(args.out, "f3.json"), "w") as f:
        json.dump(report, f, indent=1)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "ref-one":
        ref_one(int(sys.argv[2]), sys.argv[3])
        return
    parser = argparse.ArgumentParser()
    parser.add_argument("what", choices=("run", "analyze"))
    parser.add_argument("--out", required=True)
    parser.add_argument("--jobs", type=int, default=8)
    parser.add_argument("--ref-seeds", default="1,17-40")
    parser.add_argument("--port-seeds", default="9-40")
    args = parser.parse_args()
    run(args) if args.what == "run" else analyze(args)


if __name__ == "__main__":
    main()
