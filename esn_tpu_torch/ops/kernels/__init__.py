"""Hand-written CUDA kernels (counterpart of ``esn_tpu/ops/pallas``).

Each kernel has a plain PyTorch version in its module. A wrapper takes the
plain version only for a tensor on the CPU; for a CUDA tensor it launches
the kernel or raises. ``_build`` compiles ``esn_tpu_torch/csrc/*.cu`` at
first launch. K1-K4 are the counterparts of the reference's Pallas
kernels; K5 and K6 are the port's own, the backward of the bilinear
resize and of the adaptive pool in a fixed order (torch's CUDA backward
adds with atomics), so that a step on the card repeats bit for bit. K7
is the class argmax of a final transposed conv by subpixel phases (the
prediction head of seven models), which XLA computed on the TPU. K8 is
BatchNorm's moments, apply and backward (every BN of a CUDA tensor, in
training and eval), which XLA fused into its neighbours on the TPU.

``LAUNCHES`` counts, per kernel, the launches the wrappers made in this
process: a run can show that its path went through the kernels.
"""
from __future__ import annotations

import torch

LAUNCHES = {"dsconv": 0, "resize_argmax": 0, "resize_ce_fwd": 0,
            "resize_ce_bwd": 0, "cgblock": 0, "resize_bilinear_bwd": 0,
            "adaptive_pool_bwd": 0, "subpixel_argmax": 0, "bn_moments": 0,
            "bn_apply": 0, "bn_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_backward(x: torch.Tensor) -> bool:
    """Whether an op on ``x`` takes its K5/K6 autograd route: a CUDA
    tensor whose gradient is being recorded (a CPU tensor keeps torch's
    own backward, already fixed in order)."""
    return (x.device.type == "cuda" and x.requires_grad
            and torch.is_grad_enabled())


def bf16_step_gap(got: torch.Tensor, want: torch.Tensor):
    """How far a bfloat16 result lies from an emulation of the kernel's
    rounding points: the number of elements that differ, and the number
    more than one bf16 step apart (+ 2^-16 max|want|, where the value
    cancels to near 0)."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs())
    step = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    far = (g - w).abs() > step + 2.0 ** -16 * float(w.abs().max())
    return int((g != w).sum()), int(far.sum())


from .adaptive_pool_bwd import (AdaptiveAvgPool,  # noqa: E402,F401
                                adaptive_pool_bwd, adaptive_pool_bwd_ref)
from .batchnorm import (BatchNormFn, bn_apply,  # noqa: E402,F401
                        bn_apply_ref, bn_backward, bn_backward_ref,
                        bn_moments, bn_moments_ref, bn_plan)
from .cgblock import (bf16_rounding_gap,  # noqa: E402,F401
                      cgblock_pre_kernel_rounding, cgblock_pre_ref,
                      fused_cgblock_pre)
from .dsconv import (dsconv_kernel_rounding, dsconv_ref,  # noqa: E402,F401
                     fold_bn, fused_dsconv)
from .resize_argmax import resize_argmax, resize_argmax_ref  # noqa: E402,F401
from .resize_bilinear_bwd import (BilinearResize,  # noqa: E402,F401
                                  resize_bilinear_bwd,
                                  resize_bilinear_bwd_ref)
from .resize_ce import resize_ce_sums, resize_ce_sums_ref  # noqa: E402,F401
from .subpixel_argmax import (subpixel_argmax,  # noqa: E402,F401
                              subpixel_argmax_ref)
