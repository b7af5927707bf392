"""The device's busy ms a call in BatchNorm's forward passes: the
program's ``bn`` spans (``nn/layers.py`` ``BatchNorm.forward``, train and
eval), each the card's time between the CUDA events it records on the
current stream at its edges, less the device's idle time while the host
was inside a ``bn`` span, summed over the traced stretch and divided by
its calls. BatchNorm's backward runs on autograd's thread and is not in
it, nor is a checkpoint's recompute of the forward. None where the
program records no such span. The part of the name is the route."""
from perfbench import spans as S


def read(r, part):
    if r.route != part or r.trace is None:
        return None
    return S.device_ms_per_call(r.trace, "bn")
