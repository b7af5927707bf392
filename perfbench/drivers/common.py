"""What both drivers share: the measured window, the traced stretch, the
readings the per-layer metrics take, and the limits' verdict.

The window is a closed loop of one client: pick the next batch of the
pool, call the entry, synchronise, and again, until ``seconds`` have
passed since the window opened; the last call started inside the window
is waited for and counted, and the window closes when it returns. The
benchmark's own spans, on the host's clock: ``pick`` (the batch's
choice), ``entry`` (from the call to its return, before the
synchronise) and ``sync`` (the wait for the card).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..yardstick.peaks import BF16_TENSOR_FLOPS, least_seconds
from ..yardstick.trace import Trace


@dataclasses.dataclass
class Window:
    seconds: float
    calls: int
    latencies: List[float]          # call to synchronise, each call
    entry: List[float]              # call to return, each call


def measure(pick: Callable[[int], object], entry: Callable[[object], object],
            sync: Callable[[], None], seconds: float, first: int = 0,
            keep: Optional[Callable[[int, object], None]] = None,
            min_calls: int = 1) -> Window:
    """Run ``entry(pick(i))`` (``i`` from ``first``) in a closed loop for
    ``seconds`` and at least ``min_calls`` calls, handing each output to
    ``keep(i, out)`` once it is synchronised."""
    lat, ent = [], []
    i = first
    t_open = time.perf_counter()
    while True:
        batch = pick(i)
        t1 = time.perf_counter()
        out = entry(batch)
        t2 = time.perf_counter()
        sync()
        t3 = time.perf_counter()
        if keep is not None:
            keep(i, out)
        del out
        lat.append(t3 - t1)
        ent.append(t2 - t1)
        i += 1
        if t3 - t_open >= seconds and len(lat) >= min_calls:
            break
    return Window(t3 - t_open, len(lat), lat, ent)


def traced(pick: Callable[[int], object], entry: Callable[[object], object],
           sync: Callable[[], None], n: int, first: int) -> Trace:
    """``n`` calls under ``torch.profiler`` tracing the card alone (CUDA
    activity: host operations are not recorded, which keeps the
    profiler's cost on the host to its launch callbacks). The
    benchmark's spans are stamped with the host's wall clock in
    nanoseconds, the clock the profiler's timestamps are given in.
    Without a card (the tests) the spans alone, with no device
    operation."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile
    spans = []
    on_card = torch.cuda.is_available()
    with (profile(activities=[ProfilerActivity.CUDA]) if on_card
          else contextlib.nullcontext()) as prof:
        for i in range(first, first + n):
            t0 = time.time_ns()
            batch = pick(i)
            t1 = time.time_ns()
            out = entry(batch)
            t2 = time.time_ns()
            sync()
            t3 = time.time_ns()
            del out
            spans += [("pick", t0, t1), ("entry", t1, t2), ("sync", t2, t3)]
    spans = [(k, a * 1e-9, b * 1e-9) for k, a, b in spans]
    return Trace.from_profiler(prof, spans) if on_card else Trace([], spans)


@dataclasses.dataclass
class KernelWork:
    name: str
    patterns: List[str]
    launches: int                   # a call of the route
    least_s: float                  # a call of the route


def kernel_work(work_modules, calls: List[Dict], cell) -> List[KernelWork]:
    out = []
    for mod in work_modules:
        if mod.MODE != cell.route:
            continue
        launches = mod.launches(calls, cell)
        if launches:
            out.append(KernelWork(mod.__name__.rsplit("._", 1)[-1],
                                  list(mod.PATTERNS), len(launches),
                                  sum(least_seconds(*w) for w in launches)))
    return out


@dataclasses.dataclass
class Readings:
    """What a per-layer metric's reader may read. ``trace`` is None
    outside a traced run."""
    route: str
    window: Window
    flops_per_call: int
    kernels: List[KernelWork]
    trace: Optional[Trace]
    launches_per_call: Dict[str, float]

    def kernel_shares(self) -> Dict[str, Tuple[float, float, int]]:
        """Per kernel on this route's path: (least seconds, device
        seconds, operations matched) over the traced stretch."""
        import re
        if self.trace is None:
            return {}
        calls = self.trace.span_count("entry")
        by_name = self.trace.device_time_by_name()
        out = {}
        for k in self.kernels:
            rx = re.compile("|".join(k.patterns))
            seen = [(n, t) for n, t in by_name.items() if rx.search(n)]
            device = sum(t for _, t in seen)
            if device > 0:
                out[k.name] = (calls * k.least_s, device,
                               sum(1 for n, _, _ in self.trace.ops
                                   if rx.search(n)))
        return out

    def step_flops_share(self) -> float:
        """The window's model FLOPs over its seconds at the bf16 peak."""
        return (self.flops_per_call * self.window.calls
                / (self.window.seconds * BF16_TENSOR_FLOPS))


def describe(window: Window) -> str:
    """The window's latencies and entry times, for the log."""
    lat = window.latencies
    return (f"latency ms median {1e3 * percentile(lat, 50):.4f} p95 "
            f"{1e3 * percentile(lat, 95):.4f} p99 "
            f"{1e3 * percentile(lat, 99):.4f} max {1e3 * max(lat):.4f}; "
            f"entry ms mean {1e3 * sum(window.entry) / len(lat):.4f}")


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile, linear between order statistics."""
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def verdict(checks: List[Tuple[str, float, float]]) -> bool:
    """Every number compared lies at or under its limit (NaN fails)."""
    return all(v <= lim for _, v, lim in checks)
