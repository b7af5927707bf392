"""The hand-written kernels' share of their roofline: the sum over their
launches in the traced stretch of each launch's least time
(``perfbench/work/``: bytes at HBM's rate or operations at their peak,
from the reference model's layer shapes at the cell's sizes) over the
device time of the CUDA kernels that implement them (matched by the work
files' name patterns). The part of the name is the route."""


def read(r, part):
    if r.route != part:
        return None
    shares = r.kernel_shares().values()
    device = sum(d for _, d, _ in shares)
    if device <= 0:
        return None
    return 100.0 * sum(least for least, _, _ in shares) / device
