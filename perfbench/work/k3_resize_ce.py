"""K3, the fused x r bilinear upsample and weighted cross-entropy of the
training loss, forward and backward (``esn_tpu_torch/csrc/resize_ce.cu``):
forward 6 operations a (valid full-resolution pixel, class), backward 9;
the f32 low-resolution logits and the int32 labels read once, the
gradient written once."""
from ..yardstick.peaks import F32_FLOPS

PATTERNS = [r"resize_ce_(fwd|finish|bwd|fold)_kernel"]
MODE = "train"


def launches(calls, cell):
    out = []
    for c in calls:
        if c["name"] == "tail":
            n, k, h, w = c["args"][0]
            _, _, hh, ww = c["out"]
            z, lab = n * h * w * k * 4, n * hh * ww * 4
            out.append((z + lab, 6 * cell.valid_pixels * k, 0, F32_FLOPS))
            out.append((2 * z + lab, 9 * cell.valid_pixels * k, 0,
                        F32_FLOPS))
    return out
