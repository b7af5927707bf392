"""Rank-side case of ``tests/test_torch_resize_backward.py``: the spatial
cases of ``_torch_spatial`` with every recorded bilinear resize and
adaptive pool sent down the card's autograd route on the CPU
(``kernels.kernel_backward`` forced true), so that the sharded resize's
backward (``ops.resize._ShardedResize``) and the replicated resize run
through ``BilinearResize`` and K5's plain version, and PPM's pool through
``AdaptiveAvgPool`` and K6's. Imports no JAX, so each rank starts fast.
"""
import torch

from esn_tpu_torch.ops import kernels as K

import _torch_spatial as TS


def routed_case(calls):
    """``[TS.<case>(*args) for (case, args) in calls]`` on the K5/K6
    route, and how often each plain backward ran."""
    counts = {"resize_bilinear_bwd": 0, "adaptive_pool_bwd": 0}
    plain = {name: getattr(K, name) for name in counts}

    def counted(name):
        def run(*args, **kwargs):
            counts[name] += 1
            return plain[name](*args, **kwargs)
        return run

    K.kernel_backward = lambda x: x.requires_grad and torch.is_grad_enabled()
    for name in counts:
        setattr(K, name, counted(name))
    return [getattr(TS, case)(*args) for case, args in calls] + [counts]
