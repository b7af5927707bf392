"""Tracing and profiling helpers (counterpart of
``esn_tpu/utils/profiling.py``).

- :func:`trace`: ``torch.profiler`` over the host and, where there is
  one, the card; writes a Chrome trace (``trace.json``, for
  ``chrome://tracing`` or ui.perfetto.dev) with no tensorboard
  dependency.
- :func:`span`: a named span of the program (the train and predict
  entries, their phases, BatchNorm), recorded only while a
  ``torch.profiler`` session is open; :func:`spans` returns them.
- :func:`nan_guard`: autograd's anomaly mode with its NaN check: a
  backward that makes a NaN raises where it did.
- :class:`StepTimer`: host wall time per step, by part. The card runs
  asynchronously, so without a synchronize a step's time is the host's
  dispatch; the wait for the next batch is what shows a data stall.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

_profiler_enabled = torch._C._autograd._profiler_enabled
_graph_task_id = torch._C._current_graph_task_id


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


class Span(NamedTuple):
    """A span as :func:`spans` returns it. ``start_ns``/``end_ns`` are
    ``time.time_ns()`` (the clock ``torch.profiler`` gives its device
    timestamps in), stamped just after the opening edge's event and just
    after the closing one's. ``parent`` is the id of the span that was open on the
    same thread when this one opened (None for none), ``call`` the id of
    the outermost span open on that thread: the entry call
    (``train.step``, ``predict.step``) that the span belongs to.
    ``device_ms`` is the card's time between CUDA events recorded at the
    span's edges on the stream current when it opened: the work launched
    inside the span, in stream order, with any time the card idled in
    between (a reader of the device's trace takes that idle off); None
    where no CUDA context was initialised."""
    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[int]
    call: int
    device_ms: Optional[float]


# spans kept, the newest; older ones are dropped and counted
SPAN_CAPACITY = 1 << 16
_records: collections.deque = collections.deque(maxlen=SPAN_CAPACITY)
_dropped = 0
_records_lock = threading.Lock()
_span_ids = itertools.count(1)
_open = threading.local()           # .stack: (id, call) of each open span
_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span("train.forward"): ...``: a span of the program while a
    ``torch.profiler`` session is open (on this thread, or anywhere in
    the process: the profiler's own fast flag), else nothing at all: no
    record, no CUDA event, no ``record_function``. When on, it enters a
    ``record_function`` of the same name (the span shows in the
    profiler's trace) and keeps a :class:`Span`. A span opened while
    autograd runs a backward (a checkpoint's recompute of the forward,
    :class:`~esn_tpu_torch.nn.Recompute`) is off too: the forward's spans
    are counted once, in the forward."""
    if not (_profiler_enabled() or _autograd_profiler._is_profiler_enabled):
        return _OFF
    if _graph_task_id() != -1:
        return _OFF
    return _OpenSpan(name)


class _OpenSpan:
    __slots__ = ("name", "id", "parent", "call", "start", "record",
                 "stream", "events")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_OpenSpan":
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_span_ids)
        self.parent, self.call = stack[-1] if stack else (None, self.id)
        stack.append((self.id, self.call))
        self.record = torch.profiler.record_function(self.name)
        self.record.__enter__()
        self.events = None
        if torch.cuda.is_initialized():
            # both edges on the stream current at the opening: one lookup,
            # about 6 us of an H100 machine's host under the profiler
            self.stream = torch.cuda.current_stream()
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        # the host's edges are stamped beside the events' records: the
        # span's own bookkeeping (tens of us under the profiler) lies
        # outside it, as it lies outside the events
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _dropped
        if self.events is not None:
            self.events[1].record(self.stream)
        end = time.time_ns()
        self.record.__exit__(*exc)
        _open.stack.pop()
        row = (self.id, self.name, self.start, end, threading.get_ident(),
               self.parent, self.call, self.events)
        with _records_lock:
            if len(_records) == _records.maxlen:
                _dropped += 1
            _records.append(row)
        return False


def spans() -> List[Span]:
    """The spans kept, in the order they closed, with their device times
    (this waits for the card to reach each span's closing event)."""
    with _records_lock:
        rows = list(_records)
    out = []
    for *head, events in rows:
        ms = None
        if events is not None:
            events[1].synchronize()
            ms = events[0].elapsed_time(events[1])
        out.append(Span(*head, ms))
    return out


def spans_dropped() -> int:
    """How many spans the bounded buffer has dropped, oldest first."""
    return _dropped


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
