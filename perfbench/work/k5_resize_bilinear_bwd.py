"""K5, the backward of the model's own bilinear resizes in a fixed order
(``esn_tpu_torch/csrc/resize_bilinear_bwd.cu``): 4 operations an element
of the output gradient and 4 an element of its row-reduced
intermediate; the output gradient read once and the input gradient
written once in the compute dtype. The loss's upsample is K3's."""
from ..yardstick.peaks import F32_FLOPS

PATTERNS = [r"resize_bilinear_bwd|stream_kernel|fanin_kernel"]
MODE = "train"


def launches(calls, cell):
    out = []
    for c in calls:
        if c["cls"] == "Resize" and c["name"] != "tail" \
                and tuple(c["args"][0]) != tuple(c["out"]):
            n, ch, h, w = c["args"][0]
            ho, wo = c["out"][2:]
            g = n * ch * ho * wo
            out.append(((g + n * ch * h * w) * cell.itemsize,
                        4 * g + 4 * n * ch * ho * w, 0, F32_FLOPS))
    return out
