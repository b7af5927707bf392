"""Reduce a ``torch.profiler`` trace of the traced stretch to what the
per-layer metrics and the ``breakdown`` read.

Device operations are the trace's CUDA activities (kernels, copies,
fills); the busy time is the union of their intervals, the window the
stretch from the first of the benchmark's own spans (``pick``,
``entry``, ``sync``, stamped by the host) or device operations to the
last. Each idle gap of the
device inside the window is named by the benchmark span the host was in
at the gap's middle (``outside`` if none). The same arithmetic as
``esn_tpu_torch/tools/profile_predict.py`` and ``profile_train.py``
(device time by kernel name, idle = 1 - device / wall on one stream),
with the union of intervals in place of the sum of times.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple


class Trace:
    """``ops``: ``(name, start_s, end_s)`` of each device operation;
    ``spans``: ``(name, start_s, end_s)`` of each benchmark span, both in
    seconds on the trace's clock."""

    def __init__(self, ops: List[Tuple[str, float, float]],
                 spans: List[Tuple[str, float, float]]):
        self.spans = sorted(spans, key=lambda s: s[1])
        self.ops = sorted(ops, key=lambda o: o[1])
        # every operation traced belongs to the stretch (the card is idle
        # when the profiler starts), so the window also takes in any that
        # a small offset between the two clocks puts past a span's edge
        edges = [s[1] for s in self.spans] + [o[1] for o in self.ops]
        ends = [s[2] for s in self.spans] + [o[2] for o in self.ops]
        self.start = min(edges) if edges else 0.0
        self.end = max(ends) if ends else 0.0

    @classmethod
    def from_profiler(cls, prof, spans) -> "Trace":
        """The device operations of a ``torch.profiler`` run beside the
        benchmark's ``spans``, ``(name, start_s, end_s)`` on the same
        clock."""
        from torch.autograd import DeviceType
        ops = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA \
                    and not e.is_user_annotation():
                t0 = e.start_ns() * 1e-9
                ops.append((e.name(), t0, t0 + e.duration_ns() * 1e-9))
        return cls(ops, spans)

    def clock_check(self) -> int:
        """How many calls have a device operation that starts after the
        last call's synchronise returned and before this call was made:
        0 where the host's clock and the trace's agree."""
        early, settled = 0, float("-inf")
        starts = [o[1] for o in self.ops]
        for name, a, b in self.spans:
            if name == "entry":
                i = bisect.bisect_left(starts, settled)
                if i < len(starts) and starts[i] < a:
                    early += 1
            elif name == "sync":
                settled = b
        return early

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, a, b in self.ops:
            a, b = max(a, self.start), min(b, self.end)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def device_time_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, a, b in self.ops:
            out[name] += b - a
        return dict(out)

    def span_count(self, name: str) -> int:
        return sum(1 for s in self.spans if s[0] == name)

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Each idle stretch of the device inside the window, named by the
        host's span at its middle, longest first."""
        starts = [s[1] for s in self.spans]
        gaps, at = [], self.start
        for a, b in self.busy_intervals() + [(self.end, self.end)]:
            if a > at:
                mid = 0.5 * (a + at)
                i = bisect.bisect_right(starts, mid) - 1
                name = "outside"
                # the innermost span holding the middle: the latest start
                while i >= 0:
                    if self.spans[i][2] >= mid:
                        name = self.spans[i][0]
                        break
                    i -= 1
                gaps.append((name, a - at))
            at = max(at, b)
        return sorted(gaps, key=lambda g: -g[1])
