"""Subpixel class argmax, the fused prediction head of a final stride-2
transposed conv (K7): counterpart of ``esn_tpu/ops/classify.py``
``subpixel_argmax``, which XLA computed on the TPU (no Pallas kernel).

``argmax_o(depth_to_space(phase_logits(x)) + bias)`` -> (N, 2H, 2W) int32
with the first-max tie rule, for NHWC features x ``(N, H, W, I)`` and the
layer's weight ``(I, O, kh, kw)`` and bias. On CUDA it is the kernel of
``csrc/subpixel_argmax.cu``, which argmaxes the f32 phase logits plus the
f32 bias; on the CPU the plain :func:`subpixel_argmax_ref`, which follows
the reference's rounding (the phase logits in x's dtype, the bias added
in that dtype, then the argmax). The two can differ only where two
classes' logits lie within :func:`gap_rule` of each other.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..convolution import _pair, _subpixel_axis, depth_to_space
from ..convolution import subpixel_phase_conv
from . import LAUNCHES, _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# what the kernel takes: stride 2 on both axes, at most MAX_TAPS taps a
# phase, at most 32 classes (accumulators padded to 12, 20 or 32), and
# weights that fit its block's shared memory
STRIDE = (2, 2)
MAX_TAPS = 16
CLASS_PADS = (12, 20, 32)
MAX_SMEM = 232448


def subpixel_argmax_ref(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor], *, stride,
                        padding) -> torch.Tensor:
    """Plain version: the reference's arithmetic. The phase conv in x's
    dtype, the bias cast to it and added, the argmax per phase, the int32
    indices put in place (depth-to-space)."""
    (sh, sw) = _pair(stride)
    z = subpixel_phase_conv(x, weight, stride=stride, padding=padding)
    n, h, w, c = z.shape
    z = z.reshape(n, h, w, sh * sw, c // (sh * sw))
    if bias is not None:
        z = z + bias.to(z.dtype)
    idx = torch.argmax(z, dim=-1).to(torch.int32)       # (n, h, w, sh*sw)
    return idx.reshape(n, h, w, sh, sw).permute(0, 1, 3, 2, 4).reshape(
        n, h * sh, w * sw)


def phase_taps(kh: int, kw: int, stride, padding) -> List[List[Tuple]]:
    """Each phase's taps ``(dy, dx, slot)``, phase ``rh * sw + rw``:
    output pixel ``(sh*q + rh, sw*p + rw)`` sums ``x[q + dy, p + dx]``
    times the weight at ``slot = uh * kw + uw``."""
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    rows, cols = _subpixel_axis(kh, sh, ph), _subpixel_axis(kw, sw, pw)
    return [[(dy, dx, uh * kw + uw) for uh, dy in rows[rh]
             for uw, dx in cols[rw]]
            for rh in range(sh) for rw in range(sw)]


def class_pad(classes: int) -> int:
    """The kernel's accumulator count for ``classes`` (0: too many)."""
    return next((p for p in CLASS_PADS if classes <= p), 0)


def gap_rule(dtype: torch.dtype, weight: torch.Tensor, stride,
             padding) -> float:
    """Where two computations of the map (the kernel, the plain version,
    the reference) pick different classes a and b, ``|L_a - L_b| <=
    gap_rule * max(M_a, M_b)``: L the exact phase logits of the inputs as
    given (the weight and bias rounded to x's dtype), M the sums of the
    absolute values of their terms (:func:`phase_logits`). Each side's
    pick holds up to its own errors on the two logits, so the gap is at
    most twice the larger side's error bound e M. With n the terms of a
    logit (the most taps of a phase times I, plus the bias), any f32
    order of the sum lies within g M of L, g = 1.01 n 2^-24: f32 e = g.
    In bf16 the plain version (as the reference) rounds the phase logit to
    bf16 and its sum with the bias once more, each within 2^-8 of what it
    rounds: e = 2^-7 + 2^-14 + 2g with the second-order terms."""
    cin = weight.shape[0]
    taps = max(len(t) for t in phase_taps(*weight.shape[2:], stride,
                                          padding))
    g = 1.01 * (taps * cin + 1) * 2.0 ** -24
    if dtype == torch.float32:
        return 2 * g
    return 2 * (2.0 ** -7 + 2.0 ** -14 + 2 * g)


def phase_logits(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], *, stride, padding):
    """The full-resolution logits L and the sums of their terms' absolute
    values M, both (N, sh*H, sw*W, O) in f64, of x and of the weight and
    bias rounded to x's dtype: what :func:`gap_rule` holds a mismatch
    to."""
    (sh, sw) = _pair(stride)
    w = weight.to(x.dtype).double()
    b = (torch.zeros(w.shape[1], dtype=torch.float64, device=w.device)
         if bias is None else bias.to(x.dtype).double())
    xd = x.double()
    kw = dict(stride=stride, padding=padding)
    logits = depth_to_space(subpixel_phase_conv(xd, w, **kw), sh, sw) + b
    mag = depth_to_space(subpixel_phase_conv(xd.abs(), w.abs(), **kw),
                         sh, sw) + b.abs()
    return logits, mag


def argmax_gap(x, weight, bias, a, b, *, stride, padding):
    """``|L_a - L_b|`` and ``max(M_a, M_b)`` at every output pixel for
    the class maps a and b (:func:`phase_logits`)."""
    logits, mag = phase_logits(x, weight, bias, stride=stride,
                               padding=padding)
    ia, ib = a.long()[..., None], b.long()[..., None]
    gap = (logits.gather(-1, ia) - logits.gather(-1, ib)).abs()[..., 0]
    return gap, torch.maximum(mag.gather(-1, ia), mag.gather(-1, ib))[..., 0]


def _pack_weights(x, weight, bias):
    """The weights rounded to x's dtype (as the plain version's), in f32,
    as ``(kh*kw, I, pad)`` (slot ``uh * kw + uw``, classes from O on
    zero), and the bias the same way ``(pad,)`` (zeros without one)."""
    cin, cout, kh, kw = weight.shape
    pad = class_pad(cout)
    wp = torch.zeros((kh * kw, cin, pad), dtype=torch.float32,
                     device=x.device)
    wp[..., :cout] = weight.detach().to(x.dtype).float().permute(
        2, 3, 0, 1).reshape(kh * kw, cin, cout)
    bp = torch.zeros(pad, dtype=torch.float32, device=x.device)
    if bias is not None:
        bp[:cout] = bias.detach().to(x.dtype).float()
    return wp, bp


@functools.lru_cache(maxsize=64)
def _descriptor(x_shape, w_shape, stride, padding) -> np.ndarray:
    """The kernel's int32 descriptor: n, h, w, I, O, pad, kh*kw, the four
    phases' tap counts, then per phase MAX_TAPS ``(dy, dx, slot)``
    triples (``phase_taps``)."""
    n, h, w, cin = x_shape
    cout, kh, kw = w_shape[1:]
    taps = phase_taps(kh, kw, stride, padding)
    desc = np.zeros(7 + 4 + 4 * MAX_TAPS * 3, np.int32)
    desc[:7] = (n, h, w, cin, cout, class_pad(cout), kh * kw)
    desc[7:11] = [len(t) for t in taps]
    table = desc[11:].reshape(4, MAX_TAPS, 3)
    for i, phase in enumerate(taps):
        table[i, :len(phase)] = phase
    desc.flags.writeable = False
    return desc


# A layer's packed weights stay on the card between calls, keyed by the
# weight and bias objects (held weakly: a freed tensor never matches) and
# their version counters (an in-place update, an optimizer step or
# ``load_state_dict``, repacks). Packing is a handful of small torch ops,
# ~0.2 ms of host time a call on the card's host, as long as K7 itself
# at config 3's heads.
_PACKED: Dict[tuple, tuple] = {}


def _versions(*tensors):
    return tuple(None if t is None else t._version for t in tensors)


def _packed_weights(x, weight, bias):
    if weight.is_inference() or (bias is not None and bias.is_inference()):
        return _pack_weights(x, weight, bias)
    key = (id(weight), id(bias), x.dtype, x.device)
    hit = _PACKED.get(key)
    if (hit is not None and hit[0]() is weight
            and (bias is None or hit[1]() is bias)
            and hit[2] == _versions(weight, bias)):
        return hit[3]
    if len(_PACKED) >= 32:
        _PACKED.clear()
    packed = _pack_weights(x, weight, bias)
    _PACKED[key] = (weakref.ref(weight),
                    None if bias is None else weakref.ref(bias),
                    _versions(weight, bias), packed)
    return packed


def subpixel_argmax(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *, stride,
                    padding) -> torch.Tensor:
    """Fused class argmax of a transposed conv's output, x NHWC
    ``(N, H, W, I)``, weight ``(I, O, kh, kw)``; the caller has checked
    that the layer's output is ``stride`` times its input
    (``nn.ConvTranspose.subpixel_eligible``)."""
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    if (x.ndim != 4 or weight.ndim != 4 or weight.shape[0] != x.shape[-1]
            or (bias is not None and tuple(bias.shape) != (weight.shape[1],))):
        raise ValueError(f"subpixel_argmax: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    if x.device.type == "cpu":
        return subpixel_argmax_ref(x, weight, bias, stride=(sh, sw),
                                   padding=(ph, pw))
    if x.device.type != "cuda":
        raise ValueError(f"subpixel_argmax: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"subpixel_argmax: dtype {x.dtype} not supported "
                        f"(float32, bfloat16)")
    n, h, w, cin = x.shape
    cout, kh, kw = weight.shape[1:]
    pad = class_pad(cout)
    taps = phase_taps(kh, kw, (sh, sw), (ph, pw)) if kh >= sh and kw >= sw \
        else None
    if ((sh, sw) != STRIDE or not pad or taps is None
            or max(map(len, taps)) > MAX_TAPS
            or (kh * kw * cin + 1) * pad * 4 > MAX_SMEM):
        raise ValueError(f"subpixel_argmax: no kernel for weight "
                         f"{tuple(weight.shape)} at stride {(sh, sw)} "
                         f"(stride 2, <= {CLASS_PADS[-1]} classes, "
                         f"<= {MAX_TAPS} taps a phase)")
    if not x.is_contiguous():
        raise ValueError("subpixel_argmax: x must be contiguous NHWC")
    if weight.device != x.device or (bias is not None
                                     and bias.device != x.device):
        raise ValueError("subpixel_argmax: weight and bias on x's device")
    out = torch.empty((n, h * sh, w * sw), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    wp, bp = _packed_weights(x, weight, bias)
    desc = _descriptor(tuple(x.shape), tuple(weight.shape), (sh, sw),
                       (ph, pw))
    err = _build.library().esn_subpixel_argmax(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(wp.data_ptr()),
        ctypes.c_void_p(bp.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        _DTYPE_CODES[x.dtype], ctypes.c_void_p(desc.ctypes.data),
        ctypes.c_void_p(_build.stream(x.device.index)))
    _build.check(err, "subpixel_argmax")
    LAUNCHES["subpixel_argmax"] += 1
    return out
