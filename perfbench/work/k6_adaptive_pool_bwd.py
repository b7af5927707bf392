"""K6, the backward of the adaptive average pool in a fixed order
(``esn_tpu_torch/csrc/adaptive_pool_bwd.cu``; the pool takes its input
in f32): 1 operation an input element and 2 a pooled one; the f32
output gradient read once and the f32 input gradient written once."""
from ..yardstick.peaks import F32_FLOPS

PATTERNS = [r"pool_bwd_kernel"]
MODE = "train"


def launches(calls, cell):
    out = []
    for c in calls:
        if c["cls"] == "AdaptivePool":
            n, ch, h, w = c["args"][0]
            g = n * ch * c["out"][2] * c["out"][3]
            out.append(((g + n * ch * h * w) * 4, n * ch * h * w + 2 * g,
                        0, F32_FLOPS))
    return out
