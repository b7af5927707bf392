"""Tracing and profiling helpers (counterpart of
``esn_tpu/utils/profiling.py``).

- :func:`trace`: ``torch.profiler`` over the host and, where there is
  one, the card; writes a Chrome trace (``trace.json``, for
  ``chrome://tracing`` or ui.perfetto.dev) with no tensorboard
  dependency.
- :func:`annotate`: a named region in that trace.
- :func:`nan_guard`: autograd's anomaly mode with its NaN check: a
  backward that makes a NaN raises where it did.
- :class:`StepTimer`: host wall time per step, by part. The card runs
  asynchronously, so without a synchronize a step's time is the host's
  dispatch; the wait for the next batch is what shows a data stall.
"""
from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Profile the block into ``logdir/trace.json`` (nothing when
    ``logdir`` is empty)."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named trace region: ``with annotate("augment"): ...``."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def nan_guard(enable: bool = True) -> Iterator[None]:
    """Raise where a backward inside the block makes a NaN (debug runs
    only: anomaly mode slows every op)."""
    if not enable:
        yield
        return
    with torch.autograd.detect_anomaly(check_nan=True):
        yield


class StepTimer:
    """Host-side timing of a loop's parts: ``with timer.step(): ...`` times
    the part "step", ``with timer.step("sync"): ...`` another part, and
    ``timer.iterate(batches, "wait")`` each ``next`` of an iterator; then
    ``.summary()`` or ``.summary(part)``."""

    def __init__(self):
        self._durations: Dict[str, List[float]] = collections.defaultdict(
            list)

    @contextlib.contextmanager
    def step(self, part: str = "step") -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._durations[part].append(time.perf_counter() - t0)

    def iterate(self, iterable: Iterable, part: str = "wait") -> Iterator:
        """``iterable``'s items, the time of each ``next`` under ``part``."""
        it = iter(iterable)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self._durations[part].append(time.perf_counter() - t0)
            yield item

    def __len__(self):
        return len(self._durations["step"])

    def reset(self):
        self._durations.clear()

    def summary(self, part: str = "step") -> Optional[dict]:
        if not self._durations.get(part):
            return None
        d = np.asarray(self._durations[part]) * 1e3
        return {"steps": int(d.size),
                "mean_ms": float(d.mean()),
                "p50_ms": float(np.percentile(d, 50)),
                "p95_ms": float(np.percentile(d, 95)),
                "max_ms": float(d.max())}
