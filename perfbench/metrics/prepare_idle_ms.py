"""The device's idle ms a call that the program's ``<route>.prepare`` span
opens: the idle gaps of the traced stretch (``trace.busy_intervals()``
inside its window), each cut to the host's time inside a
``train.prepare`` or ``predict.prepare`` span
(``esn_tpu_torch.utils.profiling``), summed and divided by the stretch's
calls. None where the program records no such span. The part of the
name is the route."""
from perfbench import spans as S


def read(r, part):
    t = r.trace
    if r.route != part or t is None or not t.ops:
        return None
    spans = [s for s in S.program_spans(t) if s.name == f"{part}.prepare"]
    calls = t.span_count("entry")
    if not spans or calls == 0:
        return None
    return 1e3 * S.idle_inside(t, spans) / calls
