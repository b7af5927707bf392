"""The device's busy ms a call inside the program's ``<route>.forward``
span: the card's time between the CUDA events the span records on the
current stream at its edges (``esn_tpu_torch.utils.profiling``), less
the device's idle time while the host was inside the span, summed over
the traced stretch and divided by its calls. None where the program
records no such span. The part of the name is the route."""
from perfbench import spans as S


def read(r, part):
    if r.route != part or r.trace is None:
        return None
    return S.device_ms_per_call(r.trace, f"{part}.forward")
