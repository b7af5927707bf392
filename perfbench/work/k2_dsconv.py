"""K2, the fused depthwise-separable conv of eval mode (depthwise 3x3,
BN, ReLU, pointwise 1x1, BN, ReLU; ``esn_tpu_torch/csrc/dsconv.cu``): 18
operations a (output pixel, input channel) for the taps and their
affine, 2 Cin a (output pixel, output channel) for the pointwise product
at the tensor cores' rate in bf16; the input and output read and written
once in the compute dtype, the f32 weights and folded affines once."""
from ..yardstick.peaks import BF16_TENSOR_FLOPS, F32_FLOPS

PATTERNS = [r"dsconv_kernel"]
MODE = "predict"


def launches(calls, cell):
    out = []
    for c in calls:
        if c["cls"] != "DSConv":
            continue
        m = c["module"]
        n, cin, h, w = c["args"][0]
        ho, wo = c["out"][2:]
        cout = m.cout
        nbytes = ((n * h * w * cin + n * ho * wo * cout) * cell.itemsize
                  + (11 * cin + cin * cout + 2 * cout) * 4)
        px = n * ho * wo
        out.append((nbytes, 18 * px * cin, 2 * px * cin * cout,
                    BF16_TENSOR_FLOPS if cell.itemsize == 2 else F32_FLOPS))
    return out
