"""Fused depthwise-separable convolution (counterpart of
``esn_tpu/ops/pallas/dsconv.py``).

``dw 3x3 (stride 1/2, pad 1) -> affine -> act -> pw 1x1 -> affine -> act``
in one pass, BN folded into the affines by :func:`fold_bn`. On CUDA it is
the kernel of ``csrc/dsconv.cu`` (in bf16 its pointwise product runs on
tensor cores, with the depthwise result rounded to bf16 first, as
:func:`dsconv_kernel_rounding` writes out); on the CPU the plain
:func:`dsconv_ref`.
Forward only: a CUDA call that autograd would have to differentiate
raises.

Public functions take the reference's layout: x ``(N, H, W, Cin)``,
dw ``(3, 3, Cin)``, pw ``(Cin, Cout)``, affines ``(C,)``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import LAUNCHES, _build
from ..convolution import conv_output_size

_ACTS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0, 6),
}
_ACT_CODES = {"none": 0, "relu": 1, "relu6": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fold_bn(mean, var, gamma, beta, eps: float = 1e-5):
    """BN running stats -> f32 ``(scale, offset)``, ``y = x*scale + offset``."""
    scale = gamma * torch.rsqrt(var.float() + eps)
    return scale, beta - mean * scale


def dsconv_ref(x, dw, a1, b1, pw, a2, b2, *, stride: int = 1,
               act1: str = "relu", act2: str = "relu") -> torch.Tensor:
    """Plain version: depthwise conv in x's dtype, then the affines, acts
    and the pointwise product in f32; the result in x's dtype."""
    cin = x.shape[-1]
    k = dw.permute(2, 0, 1).unsqueeze(1).to(x.dtype)          # (Cin,1,3,3)
    h = F.conv2d(x.permute(0, 3, 1, 2), k, stride=stride, padding=1,
                 groups=cin).permute(0, 2, 3, 1)               # NHWC
    h = _ACTS[act1](h.float() * a1 + b1)
    y = torch.matmul(h, pw.float())
    return _ACTS[act2](y * a2 + b2).to(x.dtype)


def dsconv_kernel_rounding(x, dw, a1, b1, pw, a2, b2, *, stride: int = 1,
                           act1: str = "relu", act2: str = "relu"
                           ) -> torch.Tensor:
    """The kernel's rounding points in plain PyTorch, to hold the kernel to
    in bfloat16 (where :func:`dsconv_ref` rounds elsewhere): the depthwise
    sum in f32 and not rounded, ``mid = act1(dw * a1 + b1)`` rounded to x's
    dtype, pw rounded to x's dtype, their product summed in f32, the
    output rounded once (the TPU kernel's ``hmid.astype(xv.dtype)`` and
    ``pw.astype(x.dtype)``, ``esn_tpu/ops/pallas/dsconv.py:162,218``).
    Equal to the plain version in float32."""
    cin = x.shape[-1]
    k = dw.permute(2, 0, 1).unsqueeze(1).float()               # (Cin,1,3,3)
    h = F.conv2d(x.permute(0, 3, 1, 2).float(), k, stride=stride, padding=1,
                 groups=cin).permute(0, 2, 3, 1)               # NHWC, f32
    mid = _ACTS[act1](h * a1 + b1).to(x.dtype).float()
    y = torch.matmul(mid, pw.to(x.dtype).float())
    return _ACTS[act2](y * a2 + b2).to(x.dtype)


def _launch(x, dw, a1, b1, pw, a2, b2, stride, act1, act2) -> torch.Tensor:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_dsconv: dtype {x.dtype} not supported "
                        f"(float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError("fused_dsconv: x must be contiguous NHWC")
    n, h, w, cin = x.shape
    cout = pw.shape[1]
    if cout % 8:
        raise ValueError(f"fused_dsconv: Cout={cout} must be a multiple of 8")
    params = [t.to(device=x.device, dtype=torch.float32).contiguous()
              for t in (dw, a1, b1, pw, a2, b2)]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dw, a1, b1, pw, a2, b2)):
        raise RuntimeError("fused_dsconv: the CUDA kernel is forward-only; "
                           "run eval under torch.no_grad()/inference_mode")
    h_out = conv_output_size(h, 3, stride, 1)
    w_out = conv_output_size(w, 3, stride, 1)
    out = torch.empty((n, h_out, w_out, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    ptr = [ctypes.c_void_p(t.data_ptr()) for t in (x, *params, out)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.library().esn_dsconv_forward(
        *ptr, _DTYPE_CODES[x.dtype], n, h, w, cin, cout, h_out, w_out,
        stride, _ACT_CODES[act1], _ACT_CODES[act2], ctypes.c_void_p(stream))
    _build.check(err, "fused_dsconv")
    LAUNCHES["dsconv"] += 1
    return out


def fused_dsconv(x, dw, a1, b1, pw, a2, b2, *, stride: int = 1,
                 act1: str = "relu", act2: str = "relu") -> torch.Tensor:
    """Single-pass depthwise-separable conv with folded BN affines.

    Args:
      x: (N, H, W, Cin), float32 or bfloat16.
      dw: (3, 3, Cin) depthwise taps.  a1/b1: (Cin,) post-dw affine.
      pw: (Cin, Cout) pointwise weights.  a2/b2: (Cout,) post-pw affine.
      stride: 1 or 2 (padding 1, torch output sizes).
      act1/act2: 'relu' | 'relu6' | 'none'.
    Returns (N, H_out, W_out, Cout) in x's dtype, contiguous on CUDA.
    """
    if stride not in (1, 2):
        raise ValueError(f"fused_dsconv: stride {stride} not in (1, 2)")
    if act1 not in _ACTS or act2 not in _ACTS:
        raise ValueError(f"fused_dsconv: acts {act1!r}/{act2!r}")
    if x.ndim != 4:
        raise ValueError(f"fused_dsconv: x must be NHWC, got {tuple(x.shape)}")
    cin, cout = x.shape[-1], pw.shape[-1]
    want = {"dw": (dw, (3, 3, cin)), "a1": (a1, (cin,)), "b1": (b1, (cin,)),
            "pw": (pw, (cin, cout)), "a2": (a2, (cout,)), "b2": (b2, (cout,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_dsconv: {name} has shape "
                             f"{tuple(t.shape)}, want {shape}")
        if t.device != x.device:
            raise ValueError(f"fused_dsconv: {name} on {t.device}, x on "
                             f"{x.device}")
    if x.device.type == "cpu":
        return dsconv_ref(x, dw, a1, b1, pw, a2, b2, stride=stride,
                          act1=act1, act2=act2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dsconv: no kernel for device {x.device}")
    return _launch(x, dw, a1, b1, pw, a2, b2, stride, act1, act2)
