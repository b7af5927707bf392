"""A cell's traced stretch read through the program's own spans, in one
process on the card.

    python3 -m perfbench.tools.spans --workload NAME [NAME ...]
        [--seed N] [--seconds 20] [--out FILE]

Runs each cell as ``perfbench.run --trace 1`` does (its driver, the
measured window, then the traced stretch) and prints one JSON object a
cell: the stretch's calls, its wall, the device's busy and idle ms a
call, the median latency a call under the profiler, the idle ms a call
by the innermost span the host was in (the program's spans, else the
benchmark's own ``pick``/``entry``/``sync``), each program span's count,
host ms and device ms a call (its edge events', the idle inside it and
the busy rest), the shift that moves the device's stamps onto the
host's clock at each sync, the device operations that carry a span's
name (none where the profiler keeps the spans' ranges out of the
device's operations), the window's end-to-end numbers and the cell's
per-layer metrics. A tree whose program records no span gives the
benchmark's spans alone.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from typing import Dict


def read_cell(name: str, seed: int, seconds: float, device, log) -> Dict:
    from perfbench import bench, run, spans as S
    cell = bench.find_cell(name)
    res = bench.driver_module(cell.route).run(
        cell, seed, seconds, True, device, time.perf_counter(), log)
    r = res["readings"]
    t = r.trace
    calls = t.span_count("entry")
    program = S.program_spans(t)
    per_span: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0.0, "host_ms": 0.0, "device_ms": 0.0})
    for s in program:
        row = per_span[s.name]
        row["count"] += 1 / calls
        row["host_ms"] += 1e3 * (s.end - s.start) / calls
        if s.device_ms is not None:
            row["device_ms"] += s.device_ms / calls
    for span_name, row in per_span.items():
        busy = S.device_ms_per_call(t, span_name)
        if busy is not None:
            row["idle_inside_ms"] = row["device_ms"] - busy
            row["busy_ms"] = busy
    entries = [s for s in t.spans if s[0] == "entry"]
    syncs = [s for s in t.spans if s[0] == "sync"]
    latency = [b[2] - a[1] for a, b in zip(entries, syncs)]
    return {
        "workload": name, "seed": seed, "correct": res["correct"],
        "calls": calls, "window_ms": 1e3 * t.window_s / calls,
        "busy_ms": 1e3 * t.busy_s() / calls,
        "idle_ms": 1e3 * (t.window_s - t.busy_s()) / calls,
        "traced_latency_ms_median": 1e3 * statistics.median(latency),
        "idle_ms_by_span": {k: 1e3 * v / calls for k, v in sorted(
            S.idle_by_span(t, program).items(), key=lambda kv: -kv[1])},
        "spans": dict(per_span),
        "clock_shift_ms": [round(1e3 * d, 4) for _, d in S.sync_knots(t)],
        "ops_named_as_spans": sorted(set(t.device_time_by_name())
                                     & set(per_span)),
        "e2e": res["e2e"], "setup_s": res["setup_s"],
        "metrics": {k: v["value"] for k, v in run.per_layer(cell, r).items()},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", nargs="+", required=True)
    p.add_argument("--seed", type=int, default=2**31 + 23)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch
    from perfbench import run
    run.cache_environment()
    if not torch.cuda.is_available():
        print("perfbench.tools.spans: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    rows = []
    for i, name in enumerate(args.workload):
        rows.append(read_cell(name, args.seed + i, args.seconds, device,
                              run.log))
        torch.cuda.empty_cache()
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
