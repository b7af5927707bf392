"""K1, the fused x r bilinear upsample and class argmax that ends a
prediction (``esn_tpu_torch/csrc/resize_argmax.cu``): 3 operations a
(full-resolution pixel, class): the y-blend of x-lerped logits (1 FMA)
and a compare and select (2); the low-resolution logits read once in the
compute dtype, the int32 map written once."""
from ..yardstick.peaks import F32_FLOPS

PATTERNS = [r"resize_argmax_kernel"]
MODE = "predict"


def launches(calls, cell):
    out = []
    for c in calls:
        if c["name"] == "tail":
            n, k, h, w = c["args"][0]
            _, _, hh, ww = c["out"]
            out.append((n * h * w * k * cell.itemsize + n * hh * ww * 4,
                        3 * n * hh * ww * k, 0, F32_FLOPS))
    return out
