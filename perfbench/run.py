"""Run one cell of the benchmark once.

    python3 -m perfbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``esn_tpu_torch``. The cell is an
entry of ``BENCHMARK.json``'s ``workloads``; its traffic mix names the
driver (``perfbench/drivers/``). With ``--trace 0`` the result's metrics
are the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics (``perfbench/metrics/``), read after the same measured window
from its spans, the kernels' launch counters and a traced stretch of the
same calls under ``torch.profiler``. The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit); the last lines of standard error give
the same numbers and limits. Without as many CUDA devices as the cell
asks for, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits non-zero.

Build and kernel caches go to ``.perfbench_cache/`` in the checkout.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

from perfbench import bench  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "esn_tpu")
CACHE = bench.ROOT / ".perfbench_cache"
TOP = 10


def cache_environment() -> None:
    """Fixed cache directories inside the checkout, for every compiler a
    run could reach."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def per_layer(cell: bench.Cell, readings) -> Dict[str, Dict]:
    out = {}
    for m in cell.per_layer:
        reader, part = bench.metric_reader(m["name"])
        value = reader.read(readings, part)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(readings) -> Dict:
    t = readings.trace
    ops = sorted(t.device_time_by_name().items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:160], s] for n, s in ops[:TOP]],
            "idle_gaps": [[n, s] for n, s in t.idle_gaps()[:TOP]]}


def describe_trace(readings) -> None:
    t = readings.trace
    calls = t.span_count("entry")
    log(f"traced stretch: {calls} calls, window {t.window_s:.6f} s, "
        f"device busy {t.busy_s():.6f} s; calls whose first device "
        f"operation precedes them on the host's clock: {t.clock_check()}")
    log(f"idle share of the traced stretch itself: "
        f"{1 - t.busy_s() / t.window_s:.6f}")
    idle: Dict[str, float] = {}
    for name, s in t.idle_gaps():
        idle[name] = idle.get(name, 0.0) + s
    log("device idle by host span (s): " + json.dumps(idle))
    launches = {k.name: k.launches for k in readings.kernels}
    for name, (least, device, ops) in readings.kernel_shares().items():
        log(f"kernel {name}: {launches[name]} launches and {ops / calls:g} "
            f"device ops a call, least {1e3 * least / calls:.6f} ms, device "
            f"{1e3 * device / calls:.6f} ms a call, share "
            f"{100 * least / device:.4f}%")


def run(args, device=None, fault: Optional[Callable] = None,
        cell: Optional[bench.Cell] = None) -> int:
    """One run; ``device`` and ``fault`` are for the tests (a CPU device,
    a planted fault): the command line always asks for the card."""
    import torch
    cell = cell or bench.find_cell(args.workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            log(f"perfbench: the cell needs {cell.chips} CUDA device(s); "
                f"found {torch.cuda.device_count()}")
            return 2
        device = torch.device("cuda", 0)
    driver = bench.driver_module(cell.route)
    res = driver.run(cell, args.seed, args.seconds, bool(args.trace), device,
                     T0, log, fault=fault)
    bad = forbidden_modules()
    if bad:
        log(f"perfbench: loaded in this process: {', '.join(bad)}")
        return 3
    readings = res["readings"]
    if args.trace:
        metrics = per_layer(cell, readings)
    else:
        metrics = {m["name"]: {"value": (res["setup_s"] if m["name"] ==
                                         "setup_s" else res["e2e"][m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    is_cuda = device.type == "cuda"
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if is_cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": res["peak_bytes"]}
    log(f"device: {power_limit() if is_cuda else 'cpu'}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log(f"kernel launches a call: {json.dumps(readings.launches_per_call)}")
    log(f"setup_s {res['setup_s']:.6f}; window "
        f"{readings.window.seconds:.6f} s, {readings.window.calls} calls")
    out = {"correct": bool(res["correct"]), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    if args.trace and readings.trace is not None:
        dev["busy_s"] = readings.trace.busy_s()
        dev["window_s"] = readings.trace.window_s
        out["breakdown"] = breakdown(readings)
        describe_trace(readings)
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in res["checks"]}
    for name, v, lim in res["checks"]:
        log(f"check {name} {v!r} limit {lim!r} "
            f"{'ok' if v <= lim else 'OVER'}")
    print(json.dumps(out), flush=True)
    return 0


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_environment()
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
