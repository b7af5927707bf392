"""K4, CGNet's fused context-guided block of eval mode up to its gate
(1x1 reduce, BN, PReLU, the local and the dilated depthwise 3x3, BN,
PReLU, and the spatial sums; ``esn_tpu_torch/csrc/cgblock.cu``): 2 C a
(pixel, reduced channel) for the reduce at the tensor cores' rate in
bf16 and 36 a (pixel, reduced channel) for the two stencils; the input
read and the joined output written once in the compute dtype, the f32
sums, weights and affines once."""
from ..yardstick.peaks import BF16_TENSOR_FLOPS, F32_FLOPS

PATTERNS = [r"cgblock_kernel|cgblock_sum_kernel"]
MODE = "predict"


def launches(calls, cell):
    out = []
    for c in calls:
        if c["cls"] != "CGBlock":
            continue
        n, ch, h, w = c["args"][0]
        px, half, es = n * h * w, ch // 2, cell.itemsize
        out.append((2 * px * ch * es + n * ch * 4
                    + (ch * half + 22 * half + 3 * ch) * 4,
                    36 * px * half, 2 * px * ch * half,
                    BF16_TENSOR_FLOPS if es == 2 else F32_FLOPS))
    return out
