"""The program's own spans (``esn_tpu_torch.utils.profiling.spans()``)
beside the traced stretch.

The program records a span only while a ``torch.profiler`` session is
open, on ``time.time_ns()``, the clock of the benchmark's own spans. Each
span may carry ``device_ms``, the card's time between CUDA events
recorded on the current stream at its edges, which holds the card's idle
time inside the span; the readers take that idle off. A program that
records no span (a tree older than the span layer, or a run on the CPU)
gives none here, and the readers built on these functions then return
None.

The profiler's device timestamps drift from the host's clock: on an H100
machine by up to about 2 ms a second, reset now and then, so that by a
traced stretch's last calls a device operation may be stamped ms before
its own launch. Whatever sets a device gap beside a host span here first
moves the device operations onto the host's clock (:func:`aligned`).
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from .yardstick.trace import Trace


class ProgramSpan(NamedTuple):
    name: str
    start: float            # seconds on the trace's clock
    end: float
    device_ms: Optional[float]


def program_spans(trace: Trace) -> List[ProgramSpan]:
    """The program's spans that lie inside the traced stretch
    (``trace.start`` to ``trace.end``), by start; none where the
    program's bounded buffer dropped a span that closed in the stretch
    (the readers would undercount)."""
    try:
        from esn_tpu_torch.utils import profiling
    except ImportError:
        return []
    recorded = getattr(profiling, "spans", None)
    if recorded is None:
        return []
    rows = recorded()
    dropped = getattr(profiling, "spans_dropped", lambda: 0)()
    # the buffer drops its oldest rows: the stretch is whole where the
    # oldest row kept closed before the stretch began
    if dropped and rows and rows[0].end_ns * 1e-9 >= trace.start:
        return []
    out = [ProgramSpan(s.name, s.start_ns * 1e-9, s.end_ns * 1e-9,
                       s.device_ms) for s in rows]
    return sorted((s for s in out
                   if trace.start <= s.start and s.end <= trace.end),
                  key=lambda s: s.start)


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    """Each stretch of the window in which the device runs nothing, as
    ``(start, end)``, in order (``Trace.idle_gaps``' arithmetic)."""
    gaps, at = [], trace.start
    for a, b in trace.busy_intervals() + [(trace.end, trace.end)]:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    return gaps


def sync_knots(trace: Trace, reach: float = 2e-3
               ) -> List[Tuple[float, float]]:
    """``(device timestamp, shift)`` at each call's synchronise: the
    seconds that move the device's stamps onto the host's clock there.
    When the host's ``sync`` returns the card has just run the call's last
    operation, so the idle gap that opens there starts at the sync's end:
    the shift is the sync's end less that gap's start, the longest gap
    within ``reach`` of where the last shift puts the sync's end."""
    gaps = idle_gaps(trace)
    ends = [b for _, b in gaps]
    knots: List[Tuple[float, float]] = []
    shift = 0.0
    for name, _, end in trace.spans:
        if name != "sync":
            continue
        want = end - shift
        best = None
        for a, b in gaps[bisect.bisect_left(ends, want - reach):]:
            if a > want + reach:
                break
            if best is None or b - a > best[1] - best[0]:
                best = (a, b)
        if best is not None and (not knots or best[0] > knots[-1][0]):
            shift = end - best[0]
            knots.append((best[0], shift))
    return knots


def clock_shift(trace: Trace) -> Callable[[float], float]:
    """A function of a device timestamp: the seconds that move it onto the
    host's clock, interpolated between the :func:`sync_knots` on the
    device's clock and held before the first and after the last; 0 where
    the trace has no sync or no gap."""
    knots = sync_knots(trace)
    xs = [x for x, _ in knots]

    def at(t: float) -> float:
        if not knots:
            return 0.0
        j = bisect.bisect_left(xs, t)
        if j == 0:
            return knots[0][1]
        if j == len(knots):
            return knots[-1][1]
        (x0, s0), (x1, s1) = knots[j - 1], knots[j]
        return s0 + (s1 - s0) * (t - x0) / (x1 - x0)
    return at


def aligned(trace: Trace) -> Trace:
    """The trace with each device operation moved onto the host's clock by
    :func:`clock_shift` at its start (its duration kept)."""
    shift = clock_shift(trace)
    ops = []
    for name, a, b in trace.ops:
        d = shift(a)
        ops.append((name, a + d, b + d))
    return Trace(ops, trace.spans)


def innermost(spans: List[Tuple]) -> Callable[[float], Optional[str]]:
    """A function of a time ``t``: the name of the innermost span (the
    latest to start) of ``spans`` (``(name, start, end, ...)``, sorted by
    start) that holds ``t``, or None."""
    starts = [s[1] for s in spans]

    def at(t: float) -> Optional[str]:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            if spans[i][2] >= t:
                return spans[i][0]
            i -= 1
        return None
    return at


def idle_inside(trace: Trace, spans: List[ProgramSpan]) -> float:
    """Seconds of the device's idle gaps (:func:`aligned`) that overlap
    ``spans`` (each gap cut to the union of the spans' host intervals).
    While the card idles
    it has run all that was launched, so the span the host is in then is
    the one whose work the card waits for: this is the idle between the
    events at those spans' edges."""
    union: List[List[float]] = []
    for s in sorted(spans, key=lambda s: s.start):
        if union and s.start <= union[-1][1]:
            union[-1][1] = max(union[-1][1], s.end)
        else:
            union.append([s.start, s.end])
    total, i = 0.0, 0
    for a, b in idle_gaps(aligned(trace)):
        while i < len(union) and union[i][1] <= a:
            i += 1
        j = i
        while j < len(union) and union[j][0] < b:
            total += min(b, union[j][1]) - max(a, union[j][0])
            j += 1
    return total


def idle_by_span(trace: Trace, spans: List[ProgramSpan]) -> Dict[str, float]:
    """Seconds of idle device time by the innermost span, the program's
    or the benchmark's own (``pick``, ``entry``, ``sync``), the host was
    in (``outside`` where none holds it): each gap (:func:`aligned`)
    split at the spans' edges inside it."""
    every = sorted([tuple(s) for s in trace.spans]
                   + [tuple(s) for s in spans], key=lambda s: s[1])
    owner = innermost(every)
    edges = sorted({t for s in every for t in s[1:3]})
    out: Dict[str, float] = defaultdict(float)
    for a, b in idle_gaps(aligned(trace)):
        lo, hi = bisect.bisect_right(edges, a), bisect.bisect_left(edges, b)
        cuts = [a] + edges[lo:hi] + [b]
        for x, y in zip(cuts, cuts[1:]):
            if y - x > 1e-9:        # below the clocks' nanosecond
                out[owner(0.5 * (x + y)) or "outside"] += y - x
    return dict(out)


def device_ms_per_call(trace: Trace, name: str) -> Optional[float]:
    """The device's busy ms a call inside the spans named ``name`` in the
    traced stretch: their edge events' ms, less the idle that overlaps
    them (:func:`idle_inside`), per call of the entry; None where no such
    span has a device time."""
    named = [s for s in program_spans(trace)
             if s.name == name and s.device_ms is not None]
    calls = trace.span_count("entry")
    if not named or calls == 0:
        return None
    return (sum(s.device_ms for s in named)
            - 1e3 * idle_inside(trace, named)) / calls
