"""The whole step's share of the card's bf16 peak: the model FLOPs of one
call (the reference model at the cell's shapes, forward alone on the
predict route, forward and backward on the train route;
``perfbench/yardstick/shapes.py``) times the calls of the measured
window, over the window's seconds times 989 TFLOP/s. The part of the
name is the route."""


def read(r, part):
    if r.route != part or r.window.calls == 0 or r.flops_per_call <= 0:
        return None
    return 100.0 * r.step_flops_share()
