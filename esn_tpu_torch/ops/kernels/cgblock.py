"""Fused CGNet context-guided block up to its global gate (counterpart of
``esn_tpu/ops/pallas/cgblock.py``).

``x -> (j, sum_hw(j))`` with ``y = PReLU(a1*(x@w1) + b1, p1)`` (C -> C/2)
and ``j = PReLU(a2*cat(dw3x3(y), dw3x3_dil_d(y)) + b2, p2)``, BN folded into
the affines. On CUDA it is the kernel of ``csrc/cgblock.cu``; on the CPU
the plain :func:`cgblock_pre_ref`. Forward only: a CUDA call that autograd
would have to differentiate raises (the reference's VJP differentiates its
plain version, and training never reaches the kernel).

Public functions take the reference's layout: x ``(N, H, W, C)``, w1
``(C, C/2)``, taps ``(3, 3, C/2)``, affines and slopes ``(C/2,)`` / ``(C,)``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import LAUNCHES, _build, bf16_step_gap

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _prelu(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0, v, a * v)


def _cgblock_pre_f32(x, w1, a1, b1, p1, dwl, dws, a2, b2, p2, d, tap_dtype):
    """f32 j before its rounding; y rounded to x's dtype, the depthwise
    convs in ``tap_dtype``."""
    half = w1.shape[1]
    y = torch.matmul(x.float(), w1.to(x.dtype).float())
    y = _prelu(y * a1 + b1, p1).to(x.dtype).permute(0, 3, 1, 2).to(tap_dtype)
    taps = lambda t: t.permute(2, 0, 1).unsqueeze(1).to(tap_dtype)  # noqa: E731
    loc = F.conv2d(y, taps(dwl), padding=1, groups=half)
    sur = F.conv2d(y, taps(dws), padding=d, dilation=d, groups=half)
    j = torch.cat([loc, sur], dim=1).permute(0, 2, 3, 1).float()
    return _prelu(j * a2 + b2, p2)


def cgblock_pre_ref(x, w1, a1, b1, p1, dwl, dws, a2, b2, p2, *, d: int):
    """Plain version: the reduce product of x and w1 (cast to x's dtype)
    summed in f32, affine + PReLU in f32, y rounded to x's dtype; both
    depthwise convs in x's dtype (SAME zero padding of y); cat, f32 affine
    + PReLU, j in x's dtype. Returns ``(j, j.float().sum((1, 2)))``."""
    j = _cgblock_pre_f32(x, w1, a1, b1, p1, dwl, dws, a2, b2, p2, d,
                         x.dtype).to(x.dtype)
    return j, j.float().sum((1, 2))


def cgblock_pre_kernel_rounding(x, w1, a1, b1, p1, dwl, dws, a2, b2, p2, *,
                                d: int):
    """The kernel's rounding points in plain PyTorch, to hold the kernel to
    in bfloat16 (where :func:`cgblock_pre_ref` rounds more often): y rounded
    to x's dtype, the depthwise sums in f32 with f32 taps and not rounded,
    j rounded once; the sums over the f32 j (as the TPU kernel's body,
    ``esn_tpu/ops/pallas/cgblock.py:105``). Equal to the plain version in
    float32."""
    j = _cgblock_pre_f32(x, w1, a1, b1, p1, dwl, dws, a2, b2, p2, d,
                         torch.float32)
    return j.to(x.dtype), j.sum((1, 2))


def bf16_rounding_gap(j, s, je, se):
    """How far a bfloat16 result ``(j, s)`` lies from
    :func:`cgblock_pre_kernel_rounding`'s ``(je, se)``: the number of
    elements of j that differ, the number beyond one bf16 step (+ 2^-16
    max|je|, where j cancels to near 0), and the largest sum error relative
    to sum|je| per (n, c)."""
    differ, far = bf16_step_gap(j, je)
    sum_rel = float(((s - se).abs() / je.float().abs().sum((1, 2))).max())
    return differ, far, sum_rel


def _launch(x, params, d: int, max_blocks: int):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_cgblock_pre: dtype {x.dtype} not supported "
                        f"(float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError("fused_cgblock_pre: x must be contiguous NHWC")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *params)):
        raise RuntimeError("fused_cgblock_pre: the CUDA kernel is "
                           "forward-only; run eval under "
                           "torch.no_grad()/inference_mode")
    n, h, w, c = x.shape
    j = torch.empty_like(x)
    sums = torch.empty((n, c), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return j, sums.zero_()
    code = _DTYPE_CODES[x.dtype]
    lib = _build.library()
    tiles = lib.esn_cgblock_pre_tiles(code, n, h, w, c, d)
    if tiles < 0:
        raise ValueError(f"fused_cgblock_pre: no plan for x {tuple(x.shape)} "
                         f"d={d} fits in shared memory")
    partial = torch.empty((n, tiles, c), dtype=torch.float32, device=x.device)
    params = [t.to(device=x.device, dtype=torch.float32).contiguous()
              for t in params]
    ptr = [ctypes.c_void_p(t.data_ptr())
           for t in (x, *params, j, partial, sums)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.esn_cgblock_pre(*ptr, code, n, h, w, c, d, max_blocks,
                              ctypes.c_void_p(stream))
    _build.check(err, "fused_cgblock_pre")
    LAUNCHES["cgblock"] += 1
    return j, sums


def fused_cgblock_pre(x, w1, a1, b1, p1, dwl, dws, a2, b2, p2, *, d: int,
                      max_blocks: int = 0):
    """Single-pass CG block up to the gate, BN folded into the affines.

    Args:
      x: (N, H, W, C), float32 or bfloat16, C even.
      w1: (C, C/2) reduce weights.  a1/b1/p1: (C/2,) reduce affine, slopes.
      dwl/dws: (3, 3, C/2) local and surround depthwise taps.
      a2/b2/p2: (C,) join affine and slopes.  d: surround dilation >= 1.
      max_blocks: on CUDA, a cap on the kernel's grid of persistent blocks
        (0: as many as the card keeps resident); the result does not
        depend on it, bit for bit.
    Returns ``(j, sums)``: j (N, H, W, C) in x's dtype, contiguous, and the
    f32 sum of j over (H, W), (N, C).
    """
    if x.ndim != 4 or x.shape[-1] % 2:
        raise ValueError(f"fused_cgblock_pre: x must be NHWC with an even C, "
                         f"got {tuple(x.shape)}")
    if int(d) != d or d < 1:
        raise ValueError(f"fused_cgblock_pre: dilation d={d} must be >= 1")
    c = x.shape[-1]
    half = c // 2
    want = {"w1": (w1, (c, half)), "a1": (a1, (half,)), "b1": (b1, (half,)),
            "p1": (p1, (half,)), "dwl": (dwl, (3, 3, half)),
            "dws": (dws, (3, 3, half)), "a2": (a2, (c,)), "b2": (b2, (c,)),
            "p2": (p2, (c,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_cgblock_pre: {name} has shape "
                             f"{tuple(t.shape)}, want {shape}")
        if t.device != x.device:
            raise ValueError(f"fused_cgblock_pre: {name} on {t.device}, x on "
                             f"{x.device}")
    params = (w1, a1, b1, p1, dwl, dws, a2, b2, p2)
    if x.device.type == "cpu":
        return cgblock_pre_ref(x, *params, d=int(d))
    if x.device.type != "cuda":
        raise ValueError(f"fused_cgblock_pre: no kernel for device {x.device}")
    return _launch(x, params, int(d), int(max_blocks))
