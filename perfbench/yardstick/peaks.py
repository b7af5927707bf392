"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity, at the full 700 W power limit)."""
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12            # outside the tensor cores


def least_seconds(nbytes: float, f32_ops: float, product_ops: float = 0.0,
                  product_rate: float = F32_FLOPS) -> float:
    """The least time the card could take for this work: the larger of
    the bytes over HBM's rate and the operations over their peaks
    (products of bf16 operands at the tensor cores' rate, everything else
    at the f32 rate)."""
    return max(nbytes / HBM_BYTES_PER_S,
               f32_ops / F32_FLOPS + product_ops / product_rate)
