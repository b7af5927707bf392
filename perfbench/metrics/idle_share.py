"""The device's idle share in the measured window: 1 - (the device's
busy time a call, the union of its operations' intervals in the traced
stretch / the measured window's wall a call). The traced stretch's own
wall is not the base: the profiler's launch callbacks slow the calls of
a cell bound by its host, while the device's time a call stays as it
was. The part of the name is the route."""


def read(r, part):
    t = r.trace
    if r.route != part or t is None or not t.ops or r.window.calls == 0:
        return None
    busy_per_call = t.busy_s() / t.span_count("entry")
    return 100.0 * (1.0 - busy_per_call * r.window.calls / r.window.seconds)
