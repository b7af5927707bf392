"""Hand-written CUDA kernels (counterpart of ``esn_tpu/ops/pallas``).

Each kernel has a plain PyTorch version in its module. A wrapper takes the
plain version only for a tensor on the CPU; for a CUDA tensor it launches
the kernel or raises. ``_build`` compiles ``esn_tpu_torch/csrc/*.cu`` at
first launch.

``LAUNCHES`` counts, per kernel, the launches the wrappers made in this
process: a run can show that its path went through the kernels.
"""
from __future__ import annotations

LAUNCHES = {"dsconv": 0, "resize_argmax": 0, "resize_ce_fwd": 0,
            "resize_ce_bwd": 0, "cgblock": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


from .cgblock import (bf16_rounding_gap,  # noqa: E402,F401
                      cgblock_pre_kernel_rounding, cgblock_pre_ref,
                      fused_cgblock_pre)
from .dsconv import dsconv_ref, fold_bn, fused_dsconv  # noqa: E402,F401
from .resize_argmax import resize_argmax, resize_argmax_ref  # noqa: E402,F401
from .resize_ce import resize_ce_sums, resize_ce_sums_ref  # noqa: E402,F401
