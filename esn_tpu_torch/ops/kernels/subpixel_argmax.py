"""Subpixel class argmax, the fused prediction head of a final stride-2
transposed conv (K7): counterpart of ``esn_tpu/ops/classify.py``
``subpixel_argmax``, which XLA computed on the TPU (no Pallas kernel).

``argmax_o(depth_to_space(phase_logits(x)) + bias)`` -> (N, 2H, 2W) int32
with the first-max tie rule, for NHWC features x ``(N, H, W, I)`` and the
layer's weight ``(I, O, kh, kw)`` and bias. On CUDA it is the kernel of
``csrc/subpixel_argmax.cu``, which argmaxes the f32 phase logits plus the
f32 bias (bf16: tensor-core products over tiles of x staged in shared
memory, :func:`plan_bf16`; f32: FMAs); on the CPU the plain
:func:`subpixel_argmax_ref`, which follows the reference's rounding (the
phase logits in x's dtype, the bias added in that dtype, then the
argmax). The two can differ only where two classes' logits lie within
:func:`gap_rule` of each other.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..convolution import _pair, _subpixel_axis, depth_to_space
from ..convolution import subpixel_phase_conv
from . import LAUNCHES, _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# what the kernel takes: stride 2 on both axes, at most MAX_TAPS taps a
# phase, at most 32 classes (f32 accumulators padded to 12, 20 or 32; bf16
# classes padded to 8, 12, 20 or 32, 4 a phase in each n-tile of a phase
# pair's product), and weights that fit its block's shared memory
STRIDE = (2, 2)
MAX_TAPS = 16
CLASS_PADS = (12, 20, 32)
MAX_SMEM = 232448
# bf16 tiles: TILE_W low-res columns (the tensor-core product's M) by one
# of TILE_ROWS rows (16: two rows a warp of the block's eight); a plan
# whose shared memory fits SMEM_TWO_BLOCKS leaves room for two blocks an SM
TILE_W = 16
TILE_ROWS = (16, 8, 4, 2, 1)
SMEM_TWO_BLOCKS = 115712
# the phase pairs' tables: at most MAX_PAIRS offsets a pair, in shared
# memory an int4 (A offset, the two phases' B offsets, 0) each
MAX_PAIRS = 2 * MAX_TAPS
TAP_BYTES = 2 * MAX_PAIRS * 16


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
    rounds: e = 2^-7 + 2^-14 + 2g with the second-order terms. The
    kernel's bf16 route sums on the tensor cores: bf16 x bf16 products are
    exact in f32, and even if the cores truncated each f32 sum instead of
    rounding it, each of its n additions would be off by at most 2^-23 of
    a partial sum, so its logits lie within about n 2^-23 M = 2g M of L
    (ENet's n = 145 terms: 1.7e-5 M), far inside the plain side's
    2^-7 M; the larger side's bound, and so the rule, stays the same."""
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


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


class Plan(NamedTuple):
    """The bf16 route's tiles and shared memory (``csrc/subpixel_argmax.cu``
    ``Plan``, field for field): K and the classes padded (``kp`` to 16,
    ``np`` to :func:`pair_classes`), a staged pixel's and a B row's stride
    ``ldk = kp + 8`` bf16 (an odd count of 16-byte units), ``th`` low-res
    rows a tile, ``nbuf`` x buffers, the taps' least offsets ``y0``, ``x0`` and the
    staged ``rows`` x ``cols`` (the tile and the taps' halo), byte offsets
    of the weights (their slots and a zero slot) and the tiles after the
    f32 bias and the pair tables (``TAP_BYTES``), one tile's bytes and the
    block's, and a cap on the grid (0: as many blocks as fit)."""
    kp: int
    np: int
    ldk: int
    th: int
    nbuf: int
    y0: int
    x0: int
    rows: int
    cols: int
    o_w: int
    o_x: int
    tile_bytes: int
    bytes: int
    max_blocks: int


def pair_classes(classes: int) -> int:
    """Classes a phase, padded, in the bf16 route's phase-pair products: 4
    times its n-tiles (2, 3, 5 or 8; 0: too many classes)."""
    return 4 * next((n for n in (2, 3, 5, 8) if classes <= 4 * n), 0)


def pair_taps(taps, nslots: int):
    """Each phase pair's offsets (pair rh: phases (rh, 0), (rh, 1)), as
    ``(dy, dx, slot of (rh, 0), slot of (rh, 1))``: (rh, 0)'s taps in
    order, then those of (rh, 1) at other offsets; ``nslots`` (the zero
    slot) where a phase reads nothing at the offset."""
    pairs = []
    for rh in range(2):
        first = {(dy, dx): s for dy, dx, s in taps[2 * rh]}
        second = {(dy, dx): s for dy, dx, s in taps[2 * rh + 1]}
        offsets = list(first) + [o for o in second if o not in first]
        pairs.append([(dy, dx, first.get((dy, dx), nslots),
                       second.get((dy, dx), nslots)) for dy, dx in offsets])
    return pairs


@functools.lru_cache(maxsize=64)
def plan_bf16(cin: int, cout: int, nslots: int, taps,
              max_blocks: int = 0) -> Optional[Plan]:
    """The bf16 plan for ``taps`` (``phase_taps`` as tuples): the first of
    two buffers, then one, each at 16, 8, 4, 2 and 1 rows, whose shared
    memory fits two blocks an SM, else the first that fits one; None
    where none fits (the weights alone are too large)."""
    kp, npad = _round_up(cin, 16), pair_classes(cout)
    ldk = kp + 8
    dys = [dy for phase in taps for dy, _, _ in phase]
    dxs = [dx for phase in taps for _, dx, _ in phase]
    cols = TILE_W + max(dxs) - min(dxs)
    o_w = _round_up(npad * 4, 16) + TAP_BYTES
    o_x = o_w + (nslots + 1) * npad * ldk * 2
    for limit in (SMEM_TWO_BLOCKS, MAX_SMEM):
        for nbuf in (2, 1):
            for th in TILE_ROWS:
                rows = th + max(dys) - min(dys)
                tile = rows * cols * ldk * 2
                if o_x + nbuf * tile <= limit:
                    return Plan(kp, npad, ldk, th, nbuf, min(dys), min(dxs),
                                rows, cols, o_w, o_x, tile,
                                o_x + nbuf * tile, max_blocks)
    return None


def _pack_weights_bf16(weight, bias, device):
    """The bf16 route's B operand: the weights rounded to bf16 as
    ``(kh*kw + 1, np, ldk)``, element ``[slot][n][k]`` at flat index
    ``(slot * np + n) * ldk + k`` (slot ``uh * kw + uw``; zero from
    class O and from channel I on; slot kh*kw, the zero slot, all zero),
    and the bias rounded to bf16, in f32, ``(np,)`` (zeros without one)."""
    cin, cout, kh, kw = weight.shape
    npad, ldk = pair_classes(cout), _round_up(cin, 16) + 8
    wb = torch.zeros((kh * kw + 1, npad, ldk), dtype=torch.bfloat16,
                     device=device)
    wb[:-1, :cout, :cin] = weight.detach().to(torch.bfloat16).permute(
        2, 3, 1, 0).reshape(kh * kw, cout, cin)
    bb = torch.zeros(npad, dtype=torch.float32, device=device)
    if bias is not None:
        bb[:cout] = bias.detach().to(torch.bfloat16).float()
    return wb, bb


def _pack_weights(x, weight, bias):
    """The weights rounded to x's dtype (as the plain version's), in f32,
    as ``(kh*kw, I, pad)`` (slot ``uh * kw + uw``, classes from O on
    zero), and the bias the same way ``(pad,)`` (zeros without one): the
    f32 route's layout (bf16's: :func:`_pack_weights_bf16`)."""
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
def _taps(w_shape, stride, padding):
    """``phase_taps`` of a weight shape, as tuples, once a shape (the
    wrapper's host time a call sets the small heads' time)."""
    return tuple(map(tuple, phase_taps(*w_shape[2:], stride, padding)))


@functools.lru_cache(maxsize=64)
def _descriptor(x_shape, w_shape, stride, padding,
                max_blocks: int = 0) -> np.ndarray:
    """The kernel's int32 descriptor: n, h, w, I, O, pad, kh*kw, the four
    phases' tap counts, per phase MAX_TAPS ``(dy, dx, slot)`` triples
    (``phase_taps``), the bf16 route's :class:`Plan` (zeros where none
    fits), the two phase pairs' entry counts, then per pair MAX_PAIRS
    entries (:func:`pair_taps`)."""
    n, h, w, cin = x_shape
    cout, kh, kw = w_shape[1:]
    taps = _taps(w_shape, stride, padding)
    table_end = 11 + 4 * MAX_TAPS * 3
    plan_end = table_end + len(Plan._fields)
    desc = np.zeros(plan_end + 2 + 2 * MAX_PAIRS * 4, np.int32)
    desc[:7] = (n, h, w, cin, cout, class_pad(cout), kh * kw)
    desc[7:11] = [len(t) for t in taps]
    table = desc[11:table_end].reshape(4, MAX_TAPS, 3)
    for i, phase in enumerate(taps):
        table[i, :len(phase)] = phase
    plan = plan_bf16(cin, cout, kh * kw, taps, max_blocks)
    if plan is not None:
        desc[table_end:plan_end] = plan
    pairs = pair_taps(taps, kh * kw)
    desc[plan_end:plan_end + 2] = [len(pr) for pr in pairs]
    entries = desc[plan_end + 2:].reshape(2, MAX_PAIRS, 4)
    for rh, pr in enumerate(pairs):
        entries[rh, :len(pr)] = pr
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


def _pack(x, weight, bias):
    """x's route's packed weights and bias."""
    if x.dtype == torch.bfloat16:
        return _pack_weights_bf16(weight, bias, x.device)
    return _pack_weights(x, weight, bias)


def _packed_weights(x, weight, bias):
    """:func:`_pack`, kept between calls."""
    if weight.is_inference() or (bias is not None and bias.is_inference()):
        return _pack(x, weight, bias)
    key = (id(weight), id(bias), x.dtype, x.device)
    hit = _PACKED.get(key)
    if (hit is not None and hit[0]() is weight
            and (bias is None or hit[1]() is bias)
            and hit[2] == _versions(weight, bias)):
        return hit[3]
    if len(_PACKED) >= 32:
        _PACKED.clear()
    packed = _pack(x, weight, bias)
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
    return _call(x, weight, bias, stride, padding)


def _call(x, weight, bias, stride, padding, max_blocks: int = 0):
    """:func:`subpixel_argmax`, its bf16 grid capped at ``max_blocks``
    blocks where that is above 0 (the card tests' check that the grid does
    not change the map)."""
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
    taps = _taps(tuple(weight.shape), (sh, sw), (ph, pw)) \
        if kh >= sh and kw >= sw else None
    if ((sh, sw) != STRIDE or not pad or taps is None
            or max(map(len, taps)) > MAX_TAPS
            or (x.dtype == torch.float32
                and (kh * kw * cin + 1) * pad * 4 > MAX_SMEM)
            or (x.dtype == torch.bfloat16
                and (plan_bf16(cin, cout, kh * kw, taps) is None
                     or h * w * cin >= 2 ** 31))):
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
                       (ph, pw), max_blocks)
    err = _build.library().esn_subpixel_argmax(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(wp.data_ptr()),
        ctypes.c_void_p(bp.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        _DTYPE_CODES[x.dtype], ctypes.c_void_p(desc.ctypes.data),
        ctypes.c_void_p(_build.stream(x.device.index)))
    _build.check(err, "subpixel_argmax")
    LAUNCHES["subpixel_argmax"] += 1
    return out
