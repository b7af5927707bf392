#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``esn_tpu_torch/csrc``, checks each kernel
against its plain PyTorch version at the shapes Fast-SCNN's predict and
train step and CGNet's predict give it (plus odd-size cases), then drives
these paths through the port's entry points, each with the launch counts
from zero:

- predict: Fast-SCNN-19 at batch 8, 3x1024x2048, bf16
  (``build_model`` + ``make_predict_step``): output, launch counts,
  agreement with the same model on the plain versions, img/s;
- predict: CGNet-19 (M=3, N=21) the same way: 22 ``cgblock`` launches and
  one ``resize_argmax`` launch per predict;
- train: five steps of Fast-SCNN-19 at batch 8, 3x1024x2048, bf16
  (``build_model`` + ``build_optimizer("adam")`` +
  ``build_schedule("poly")`` + ``make_train_step(fwd_method=
  "logits_lowres")`` with the fused resize-CE loss): one ``resize_ce``
  forward and backward launch per step, a falling loss, moving BN
  statistics, one f32 step against the plain versions, ms/step;
- predict after a train step, for both models: a predict step built
  first, one train step, then a predict that must run in eval mode (the
  eval launch counts, BN running statistics untouched, the class map of
  an eval-mode predict), and the host time of the per-call
  ``model.eval()``;
- the index pool/unpool pair on the card, contiguous and
  ``channels_last``, f32 and bf16, on inputs with planted ties and at an
  odd size with ``output_size``: bit for bit the CPU's result;
- ENet-19 at full width and depth, batch 8, 3x1024x2048, bf16, through
  ``build_model("enet")``, ``make_predict_step``, ``make_train_step`` and
  ``make_eval_step``. No kernel lies on its path (every launch count
  stays 0), so the card is held against the CPU: the f32 predict of a
  slice, and one f32 train step on a small slice (loss, per-leaf
  gradients). Train: five steps with the config-5 loss (class-weighted CE
  + OHEM on the full-resolution logits), a falling loss, moving BN
  statistics, finite gradients on every leaf, ms/step, peak memory.
  Eval: labels made from the model's own prediction with a band of
  ignored rows and ``valid = 6`` of 8 give a diagonal confusion matrix
  and mIoU 1; an eval step built before a train step and called after it
  runs in eval mode;
- Fast-SCNN-19 with the config-5 loss, ``fwd_method=None`` (OHEM needs
  the full-resolution logits, so the step leaves the fused resize-CE
  route: ``resize_ce`` launches 0 times, and the script says so): five
  steps, a falling loss, ms/step and peak memory in turns with the
  weighted-CE step.

Exits non-zero on any failure, and when no CUDA device is present. The
last line of standard output is one JSON object; the line before it lists
the kernels. ``ms``/``plain_ms``/``bound_ms``: for ``fused_dsconv`` the
sum of its four layers' bf16 times per predict, each timed at its own
shape; for ``resize_argmax`` its time per predict; for ``resize_ce_sums``
forward + backward per train step (``chip_smoke.json`` keeps the two
apart: ``fwd_ms``, ``bwd_ms``, their bounds, and the forward's SFU floor
``fwd_sfu_floor_ms``); for ``fused_cgblock_pre`` its bf16
time per CGNet predict (2 launches at the stage2 shape, 20 at stage3's);
its ``launches`` are CGNet's. ``bound_ms`` is computed from this run's
shapes and labels (see ``bound``); ``library_ms`` is null, since no
single PyTorch call computes any of the four functions. ``max_abs_err``:
for ``resize_argmax`` the largest gap between the f32 upsampled logits of
the classes that the kernel and the plain version chose (every K1 case
also launches twice and must give the same map bit for bit); for ``resize_ce_sums`` the largest
difference of dz. ``launches`` for ``resize_ce_sums`` counts forward and
backward launches together. Details go to ``chip_smoke.json`` in the
output directory beside this script.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
CLASSES = 19
BATCH = 8
IMAGE_HW = (1024, 2048)
# fused_dsconv tolerances, |kernel - plain| <= atol + rtol * |plain|:
#  f32 (TF32 off): both sum in f32, in other orders;
#  bf16: the output rounds to bf16 (2^-8 relative); the kernel also rounds
#  mid (the depthwise result after its affine and act) and pw to bf16
#  before its tensor-core product, as the TPU kernel does, where the plain
#  version rounds the depthwise result before the affine and keeps pw f32.
DSCONV_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 2e-2)}
# bf16 also against dsconv_kernel_rounding, which rounds where the kernel
# rounds, on inputs whose depthwise sums and affine are exact in f32 (x,
# dw, a1, b1 on a dyadic grid), so mid is the same on both sides: the
# outputs differ only where the two f32 orders of the product's sum put
# the output on the other side of a bf16 rounding, at most
# DSCONV_BF16_DIFFER of the elements (plus 2), each by one bf16 step. An
# emulation that skips the mid rounding differs at ~25% (measured against
# the Pallas kernel in interpret mode on the CPU).
DSCONV_BF16_DIFFER = 1e-3
# resize_argmax: where kernel and plain pick different classes, the f32
# upsampled logits of the two classes lie within this gap, relative to the
# larger magnitude (at least 1): f32 association for f32; for bf16 the
# plain version rounds the upsampled logits to bf16 before its argmax, and
# two values round to one tie only when they lie within one bf16 ulp,
# which is at most 2^-7 of the value.
ARGMAX_GAP = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# predict with the kernels vs the same model with the plain versions. f32
# (TF32 off): re-association only. bf16: the kernel keeps the depthwise
# result in f32 where the plain version rounds it to bf16, and with random
# weights such rounding differences carry through the network (two plain
# bf16 variants of the same seeded model disagree at ~2% of pixels at
# 512x256 on the CPU).
PREDICT_MISMATCH_MAX = {"float32": 1e-4, "bfloat16": 0.05}
# ... and the largest low-res logit difference between the two runs, as a
# share of the plain run's logit std, which bounds what counts as a near
# tie there. From readings on an H100: f32 5.1e-6 (bound ~10x), bf16
# 0.121, i.e. 0.25 against a std of 2.06 (bound ~2x).
LOWRES_DIFF_MAX = {"float32": 5e-5, "bfloat16": 0.25}
VAR_FLOOR = 0.01
# resize_ce_sums (K3) against its plain version, f32, TF32 off:
# |dS| <= RESIZE_CE_SUM_REL * |S| (and N alike): both sum f32 terms over
# up to 16.7M pixels, in other orders (the kernel in double per block);
# dz rel-L2 <= RESIZE_CE_DZ_REL, as tests/test_pallas_resize_ce.py.
RESIZE_CE_SUM_REL, RESIZE_CE_DZ_REL = 1e-5, 1e-4
# train: one f32 step (TF32 off) with the kernel vs the plain versions
# from the same copied model and optimizer: the loss within
# TRAIN_LOSS_REL; per-leaf gradient rel-L2 within TRAIN_GRAD_REL (the two
# differ only in the loss tail's dz, 1e-6-level, carried back through
# cuDNN's f32 backward, which sums in its own order), plus TRAIN_GRAD_ABS
# for the leaves whose exact gradient is 0 (a BN bias whose shift the next
# train-mode BN removes; their f32 gradients are ~1e-9 of noise).
TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_GRAD_ABS = 1e-5, 1e-3, 1e-6
TRAIN_STEPS, TRAIN_TOTAL_STEPS, TRAIN_LR = 5, 1000, 4.5e-4
# fused_cgblock_pre (K4) against its plain version. j: f32 (TF32 off):
# |kernel - plain| <= 1e-4 + 1e-4 |plain| (f32 sums in other orders);
# bf16: j rounds to bf16, the plain version also rounds loc/sur (the
# kernel does not), and y can round the other way where the two f32
# reduce sums straddle a rounding boundary: one bf16 rounding of a value
# as large as the largest |j|, atol = 2^-7 max|j|, rtol = 2^-7.
# Sums: |d| <= CGBLOCK_SUM_REL * sum|j| per (n, c): f32 association; in
# bf16 the kernel sums the f32 j, the plain version the rounded j.
CGBLOCK_SUM_REL = {"float32": 1e-5, "bfloat16": 4e-3}
# bf16 also against cgblock_pre_kernel_rounding, which rounds where the
# kernel rounds (y before the taps, j once, sums over the f32 j), on inputs
# whose reduce and its affine are exact in f32 (x, w1, a1, b1 on a dyadic
# grid), so y is the same on both sides. j then differs only where the two
# f32 orders of the tap sums put j on the other side of a bf16 rounding:
# at most CGBLOCK_BF16_DIFFER of the elements (plus 2, for the small
# shapes), each by one bf16 step (+ 2^-16 max|j| where j cancels to near
# 0); sums within CGBLOCK_SUM_REL["float32"]. A skipped y rounding or a
# truncated j moves 38-50% of the elements (measured against the Pallas
# kernel in interpret mode at (2,40,64,128) d=4).
CGBLOCK_BF16_DIFFER = 1e-3
# CGNet-19 at batch 8: the two CG-block shapes of predict and their
# launches per predict (stage2: 2 blocks, stage3: 20)
CGBLOCK_MAIN = [("stage2", (BATCH, 256, 512, 64), 2, 2),
                ("stage3", (BATCH, 128, 256, 128), 4, 20)]
IGNORE = 255
# ENet has no kernel to hold against a plain version, so the card is held
# against the CPU, f32, TF32 off. Predict of a 2-image slice: the class
# maps differ at no more than ENET_MISMATCH_MAX of the pixels. Where two
# values of a pool window lie within f32 rounding of each other the two
# devices may remember other positions (at most ENET_FLIPS_MAX of the
# windows), and the unpooled value lands one pixel aside: the logits move
# by up to ~0.4 of their std inside the decoder's receptive field of that
# window (within 24 pixels of a down2 window, 8 of a down1 window).
# Outside those fields the logits differ by at most ENET_LOGIT_DIFF_MAX
# of the CPU logits' std (f32 sums in other orders through ~100 convs),
# and a mismatch is a near-tie: the CPU's logits of the two classes lie
# within twice that. One CE + OHEM train step of a 2 x 3 x 256 x 512
# slice: the loss within TRAIN_LOSS_REL; per-leaf gradient rel-L2 within
# ENET_GRAD_REL plus TRAIN_GRAD_ABS (train-mode BN makes the f32 gradient
# ill-conditioned: on the CPU alone, at 2 x 3 x 64 x 128, it moves by up
# to 1.6e-2 when the two images swap places,
# tests/test_torch_enet_train.py; read on an H100 against the CPU: 3.2e-2
# on the worst leaf, 5.8e-3 the median).
ENET_MISMATCH_MAX, ENET_LOGIT_DIFF_MAX, ENET_GRAD_REL = 1e-4, 1e-3, 8e-2
ENET_FLIPS_MAX = 1e-5
ENET_SLICE_HW = (256, 512)
EVAL_VALID = 6
# The least time the card could take for a kernel's work (bound_ms): the
# larger of its bytes (each input read once, each output written once)
# over HBM_BPS and its operations over the peak rate for their type:
# products of bf16 operands on the tensor cores (BF16_TC_FLOPS), all
# other arithmetic in f32 outside them (F32_FLOPS); NVIDIA H100 SXM data
# sheet, dense, at 700 W. Operations per element, the least each
# algorithm needs: K1 3 per (full-res pixel, class) (the y-blend of the
# column's x-lerped logits, 1 FMA, whose x-lerp a column shares over r
# rows, and a compare and select 2); K3 forward 6 per (valid full-res
# pixel, class) (the blend 2 as K1's, max, the scaled subtraction, exp and
# sum 4; the true logit and the mean are per pixel), backward 9 (lerp 2, softmax 3, gradient 2, the transposed lerp
# 2); K2 18 per (output pixel, input channel) for the depthwise taps and
# 2 Cin per (output pixel, output channel) for the pointwise product; K4
# 2 C per (pixel, reduced channel) for the reduce and 36 per (pixel,
# reduced channel) for the two stencils.
HBM_BPS, F32_FLOPS, BF16_TC_FLOPS = 3.35e12, 67e12, 989e12
# K3's forward also has an SFU floor, beside its bound: one exp a (valid
# pixel, class) and one log a valid pixel at SFU_PER_CLOCK results a clock
# on each SM (CUDA C++ Programming Guide, arithmetic throughput, compute
# capability 9.0), at the card's largest SM clock (nvidia-smi).
SFU_PER_CLOCK = 16


class SmokeFailure(RuntimeError):
    pass


def bound(nbytes: float, f32_ops: float, product_ops: float = 0.0,
          product_rate: float = F32_FLOPS):
    """(bound ms, what sets it) for this many bytes and operations."""
    t_bytes = nbytes / HBM_BPS
    t_ops = f32_ops / F32_FLOPS + product_ops / product_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def dsconv_bound(shape, cout, stride, itemsize):
    n, h, w, cin = shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    nbytes = ((n * h * w * cin + n * ho * wo * cout) * itemsize
              + (11 * cin + cin * cout + 2 * cout) * 4)
    px = n * ho * wo
    return bound(nbytes, 18 * px * cin, 2 * px * cin * cout,
                 BF16_TC_FLOPS if itemsize == 2 else F32_FLOPS)


def sm_clock_max_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dsconv_case(K, torch, gen, shape, cout, stride, dtype, act1="relu",
                act2="relu"):
    """K2 against its plain version, in bf16 also against the emulation of
    its rounding points; the time of each (CUDA events) and the bound."""
    n, h, w, cin = shape
    dev = "cuda"
    # in bf16, x, dw, a1 and b1 on a dyadic grid (the depthwise sums and
    # their affine exact in f32)
    q = ((lambda t, k: torch.round(t * k) / k) if dtype == torch.bfloat16
         else (lambda t, k: t))
    x = q(torch.randn(shape, generator=gen, device=dev), 8).to(dtype)
    dw = q(torch.randn((3, 3, cin), generator=gen, device=dev) / 3, 32)
    pw = torch.randn((cin, cout), generator=gen, device=dev) / math.sqrt(cin)
    a1 = q(torch.rand((cin,), generator=gen, device=dev) + 0.5, 16)
    b1 = q(torch.randn((cin,), generator=gen, device=dev) * 0.1, 256)
    a2 = torch.rand((cout,), generator=gen, device=dev) + 0.5
    b2 = torch.randn((cout,), generator=gen, device=dev) * 0.1
    args = (x, dw, a1, b1, pw, a2, b2)
    kw = dict(stride=stride, act1=act1, act2=act2)
    got = K.fused_dsconv(*args, **kw)
    ref = K.dsconv_ref(*args, **kw)
    torch.cuda.synchronize()
    check(got.shape == ref.shape and got.dtype == x.dtype,
          f"dsconv {shape} shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    err = (got.float() - ref.float()).abs()
    atol, rtol = DSCONV_TOL[str(dtype).split(".")[-1]]
    excess = float((err - atol - rtol * ref.float().abs()).max())
    row = {"shape": list(shape), "cout": cout, "stride": stride,
           "dtype": str(dtype).split(".")[-1], "acts": [act1, act2],
           "max_abs_err": float(err.max()), "atol": atol, "rtol": rtol,
           "within_tol": excess <= 0}
    if dtype == torch.bfloat16:
        differ, far = K.bf16_step_gap(got, K.dsconv_kernel_rounding(*args,
                                                                    **kw))
        allowed = 2 + DSCONV_BF16_DIFFER * got.numel()
        row.update(emul_differ=differ, emul_differ_allowed=allowed,
                   emul_far=far)
        row["within_tol"] &= differ <= allowed and far == 0
    again = K.fused_dsconv(*args, **kw)
    row["bit_identical"] = bool(torch.equal(got, again))
    row["bound_ms"], row["bound_by"] = dsconv_bound(shape, cout, stride,
                                                    x.element_size())
    row.update(ms=cuda_ms(lambda: K.fused_dsconv(*args, **kw)),
               plain_ms=cuda_ms(lambda: K.dsconv_ref(*args, **kw)))
    return row


def upsampled_gap(torch, F, y, r, a, b):
    """|L[a] - L[b]| of the f32 bilinear x r upsample L of NHWC logits y,
    and max(|L[a]|, |L[b]|, 1), at each pixel (a, b: (N, rh, rw) class
    maps)."""
    n, h, w, c = y.shape
    up = F.interpolate(y.permute(0, 3, 1, 2).float(), size=(h * r, w * r),
                       mode="bilinear", align_corners=False)
    la = up.gather(1, a.long()[:, None]).squeeze(1)
    lb = up.gather(1, b.long()[:, None]).squeeze(1)
    mag = torch.clamp(torch.maximum(la.abs(), lb.abs()), min=1.0)
    return (la - lb).abs(), mag


def resize_argmax_case(K, torch, F, gen, shape, r, dtype):
    y = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    got = K.resize_argmax(y, r)
    again = K.resize_argmax(y, r)
    ref = K.resize_argmax_ref(y, r)
    torch.cuda.synchronize()
    n, h, w, c = shape
    check(got.shape == (n, h * r, w * r) and got.dtype == torch.int32,
          f"resize_argmax {shape} r={r}: {tuple(got.shape)} {got.dtype}")
    gap, mag = upsampled_gap(torch, F, y, r, got, ref)
    rel = ARGMAX_GAP[str(dtype).split(".")[-1]]
    bound_ms, bound_by = bound(y.numel() * y.element_size() + got.numel() * 4,
                               3 * got.numel() * c)
    row = {"shape": list(shape), "r": r, "dtype": str(dtype).split(".")[-1],
           "mismatch_rate": float((got != ref).float().mean()),
           "max_abs_err": float(gap.max()), "gap_rel_tol": rel,
           "within_tol": bool((gap <= rel * mag).all()),
           "bit_identical": bool(torch.equal(got, again)),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "ms": cuda_ms(lambda: K.resize_argmax(y, r)),
           "plain_ms": cuda_ms(lambda: K.resize_argmax_ref(y, r))}
    return row


def kernel_phase(torch, F, K):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the four eval DSConvs of Fast-SCNN at batch 8
    main = [("ltd.ds1", (BATCH, 512, 1024, 32), 48, 2),
            ("ltd.ds2", (BATCH, 256, 512, 48), 64, 2),
            ("head.ds1", (BATCH, 128, 256, 128), 128, 1),
            ("head.ds2", (BATCH, 128, 256, 128), 128, 1)]
    dsconv_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, shape, cout, stride in main:
            row = dsconv_case(K, torch, gen, shape, cout, stride, dtype)
            row["layer"] = name
            dsconv_rows.append(row)
        row = dsconv_case(K, torch, gen, (2, 37, 53, 24), 16, 2, dtype,
                          act1="relu6", act2="none")
        row["layer"] = "odd"
        dsconv_rows.append(row)
    argmax_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        row = resize_argmax_case(K, torch, F, gen, (BATCH, 128, 256, CLASSES),
                                 8, dtype)
        row["layer"] = "predict tail"
        argmax_rows.append(row)
        # odd: h not a multiple of the band, a partial column tile; r = 5
        # with C = 64, the shared-memory instantiation
        for shape, r in (((2, 13, 21, CLASSES), 3), ((1, 9, 120, 64), 5)):
            row = resize_argmax_case(K, torch, F, gen, shape, r, dtype)
            row["layer"] = "odd"
            argmax_rows.append(row)
    for row in dsconv_rows + argmax_rows:
        print("kernel", json.dumps(row))
    bad = [r for r in dsconv_rows + argmax_rows if not r["within_tol"]]
    check(not bad, f"kernel outside tolerance: {bad}")
    check(all(r["bit_identical"] for r in dsconv_rows),
          "fused_dsconv: two launches differ")
    check(all(r["bit_identical"] for r in argmax_rows),
          "resize_argmax: two launches differ")
    return dsconv_rows, argmax_rows


def cgblock_args(torch, gen, shape, dtype):
    """Seeded K4 inputs; in bf16, x, w1, a1 and b1 on a dyadic grid (the
    reduce and its affine exact in f32)."""
    n, h, w, c = shape
    half, dev = c // 2, "cuda"
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    uni = lambda *s: torch.rand(s, generator=gen, device=dev)   # noqa: E731
    q = ((lambda t, k: torch.round(t * k) / k) if dtype == torch.bfloat16
         else (lambda t, k: t))
    return (q(rnd(*shape), 8).to(dtype),
            q(rnd(c, half) * 0.3 / math.sqrt(c / 64), 32),
            q(rnd(half) * 0.1 + 1.0, 16), q(rnd(half) * 0.1, 256),
            uni(half) * 0.3 + 0.1, rnd(3, 3, half) * 0.3,
            rnd(3, 3, half) * 0.3, rnd(c) * 0.1 + 1.0, rnd(c) * 0.1,
            uni(c) * 0.3 + 0.1)



def cgblock_case(K, torch, gen, shape, d, dtype):
    """K4 against its plain version: j, the sums, bit-identity over two
    launches and a third whose grid is capped at 3 blocks (other blocks
    take the units), and the time of each (CUDA events)."""
    args = cgblock_args(torch, gen, shape, dtype)
    j, s = K.fused_cgblock_pre(*args, d=d)
    j2, s2 = K.fused_cgblock_pre(*args, d=d)
    j3, s3 = K.fused_cgblock_pre(*args, d=d, max_blocks=3)   # another grid
    j0, s0 = K.cgblock_pre_ref(*args, d=d)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    check(j.shape == j0.shape and j.dtype == dtype and s.shape == s0.shape,
          f"cgblock {shape} shape {tuple(j.shape)} vs {tuple(j0.shape)}")
    err = (j.float() - j0.float()).abs()
    if name == "float32":
        atol = rtol = 1e-4
    else:
        atol, rtol = 2.0 ** -7 * float(j0.float().abs().max()), 2.0 ** -7
    excess = float((err - atol - rtol * j0.float().abs()).max())
    scale = j0.float().abs().sum((1, 2))
    sum_rel = float(((s - s0).abs() / scale).max())
    n, h, w, c = shape
    px, half, es = n * h * w, c // 2, j.element_size()
    bound_ms, bound_by = bound(
        2 * px * c * es + n * c * 4 + (c * half + 22 * half + 3 * c) * 4,
        36 * px * half, 2 * px * c * half,
        BF16_TC_FLOPS if es == 2 else F32_FLOPS)
    row = {"shape": list(shape), "d": d, "dtype": name,
           "max_abs_err": float(err.max()), "atol": atol, "rtol": rtol,
           "sum_rel_err": sum_rel, "sum_rel_tol": CGBLOCK_SUM_REL[name],
           "within_tol": excess <= 0 and sum_rel <= CGBLOCK_SUM_REL[name],
           "bound_ms": bound_ms, "bound_by": bound_by}
    if name == "bfloat16":
        differ, far, emul_sum_rel = K.bf16_rounding_gap(
            j, s, *K.cgblock_pre_kernel_rounding(*args, d=d))
        allowed = 2 + CGBLOCK_BF16_DIFFER * j.numel()
        row.update(emul_differ=differ, emul_differ_allowed=allowed,
                   emul_far=far, emul_sum_rel_err=emul_sum_rel)
        row["within_tol"] &= (differ <= allowed and far == 0 and emul_sum_rel
                              <= CGBLOCK_SUM_REL["float32"])
    row.update(
        bit_identical=bool(torch.equal(j, j2) and torch.equal(s, s2)
                           and torch.equal(j, j3) and torch.equal(s, s3)),
        ms=cuda_ms(lambda: K.fused_cgblock_pre(*args, d=d)),
        plain_ms=cuda_ms(lambda: K.cgblock_pre_ref(*args, d=d)))
    return row


def cgblock_phase(torch, K):
    """K4 at CGNet predict's two shapes and at odd shapes (odd H/W,
    d >= H/2 with half = 12, d = 1, and C = 18, whose pixels are not whole
    16-byte vectors; the strip walk's edges: H and W smaller than a strip
    and than d, a last strip of one column and a last segment of one row,
    d larger than the rows of a step, N = 1; all of them with fewer units
    than resident blocks), bf16 and f32, TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    odd = [("odd", (2, 13, 21, 64), 2), ("odd", (1, 9, 7, 24), 4),
           ("odd", (2, 16, 20, 24), 1),
           ("odd", (2, 11, 13, 18), 3),   # C*itemsize not a multiple of 16
           ("odd", (1, 5, 3, 16), 6),     # H, W < d < a strip
           ("odd", (3, 33, 65, 64), 2),   # a last strip and segment of 1
           ("odd", (1, 70, 40, 32), 9),   # d > the 8 rows of a step
           ("odd", (1, 40, 70, 128), 4)]  # N = 1 at stage3's width
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for layer, shape, d, *per_predict in CGBLOCK_MAIN + odd:
            row = cgblock_case(K, torch, gen, shape, d, dtype)
            row["layer"] = layer
            if per_predict:
                row["launches_per_predict"] = per_predict[0]
            rows.append(row)
            print("kernel", json.dumps(row))
    torch.backends.cudnn.allow_tf32 = True    # the library default again
    check(all(r["within_tol"] for r in rows),
          f"fused_cgblock_pre outside tolerance: "
          f"{[r for r in rows if not r['within_tol']]}")
    check(all(r["bit_identical"] for r in rows),
          "fused_cgblock_pre: two launches differ")
    return rows


def resize_ce_value_and_grad(torch, fn, z, lab, cw, r, eps):
    zz = z.clone().requires_grad_()
    s, n = fn(zz, lab, cw, r=r, ignore_index=IGNORE, label_smoothing=eps)
    (s / torch.clamp(n, min=1e-8)).backward()
    return s.detach(), n.detach(), zz.grad


def resize_ce_case(K, torch, gen, shape, r, eps, weighted, timed=False,
                   all_ignored=False, scale=1.0):
    """K3 against its plain version: S, N, the loss and dz; for the main
    shape also bit-identity over two launches and the times of forward
    and backward (CUDA events) of each. ``scale`` multiplies the logits
    (x100: a class spreads by more than 64 between two tap rows, where the
    forward takes each pixel's own max)."""
    b, h, w, c = shape
    z = torch.randn(shape, generator=gen, device="cuda") * scale
    lab = torch.randint(0, c, (b, h * r, w * r), generator=gen,
                        device="cuda", dtype=torch.int32)
    drop = torch.rand(lab.shape, generator=gen, device="cuda") < 0.05
    lab = torch.where(drop | all_ignored, torch.full_like(lab, IGNORE), lab)
    cw = (torch.rand((c,), generator=gen, device="cuda") + 0.5
          if weighted else None)
    s, n, dz = resize_ce_value_and_grad(torch, K.resize_ce_sums, z, lab, cw,
                                        r, eps)
    s0, n0, dz0 = resize_ce_value_and_grad(torch, K.resize_ce_sums_ref, z,
                                           lab, cw, r, eps)
    torch.cuda.synchronize()
    loss, loss0 = float(s / max(float(n), 1e-8)), float(s0 / max(float(n0),
                                                                 1e-8))
    dz_norm = float(torch.linalg.norm(dz0))
    dz_rel = float(torch.linalg.norm(dz - dz0)) / max(dz_norm, 1e-30)
    row = {"shape": list(shape), "r": r, "label_smoothing": eps, "scale": scale,
           "weighted": weighted, "S": float(s), "plain_S": float(s0),
           "N": float(n), "plain_N": float(n0), "loss": loss,
           "plain_loss": loss0, "dz_max_abs_err": float((dz - dz0).abs().max()),
           "dz_rel_l2": dz_rel}
    if all_ignored:
        ok = (float(s) == 0.0 and float(n) == 0.0 and math.isfinite(loss)
              and float(dz.abs().max()) == 0.0)
    else:
        ok = (abs(float(s - s0)) <= RESIZE_CE_SUM_REL * abs(float(s0))
              and abs(float(n - n0)) <= RESIZE_CE_SUM_REL * abs(float(n0))
              and dz_rel <= RESIZE_CE_DZ_REL)
    row["within_tol"] = bool(ok)
    if timed:
        # the bounds count the valid pixels of these labels
        nvalid = int(((lab != IGNORE) & (lab >= 0) & (lab < c)).sum())
        zbytes, lbytes = z.numel() * 4, lab.numel() * 4
        row["fwd_bound_ms"], fwd_by = bound(zbytes + lbytes, 6 * nvalid * c)
        row["bwd_bound_ms"], bwd_by = bound(2 * zbytes + lbytes,
                                            9 * nvalid * c)
        row["bound_ms"] = row["fwd_bound_ms"] + row["bwd_bound_ms"]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        row["sm_clock_max_mhz"] = sm_clock_max_mhz()
        row["fwd_sfu_floor_ms"] = 1e3 * nvalid * (c + 1) / (
            sms * SFU_PER_CLOCK * row["sm_clock_max_mhz"] * 1e6)
        row["bound_by"] = (bwd_by if row["bwd_bound_ms"] >= row["fwd_bound_ms"]
                           else fwd_by)
        again = resize_ce_value_and_grad(torch, K.resize_ce_sums, z, lab, cw,
                                         r, eps)
        row["bit_identical"] = all(bool(torch.equal(x, y)) for x, y in
                                   zip((s, n, dz), again))
        for name, fn in (("", K.resize_ce_sums),
                         ("plain_", K.resize_ce_sums_ref)):
            zz = z.clone().requires_grad_()
            kw = dict(r=r, ignore_index=IGNORE, label_smoothing=eps)
            with torch.no_grad():
                row[f"{name}fwd_ms"] = cuda_ms(lambda: fn(z, lab, cw, **kw))
            ss, nn_ = fn(zz, lab, cw, **kw)
            loss_t = ss / torch.clamp(nn_, min=1e-8)
            row[f"{name}bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
                loss_t, zz, retain_graph=True))
            row[f"{name}ms"] = row[f"{name}fwd_ms"] + row[f"{name}bwd_ms"]
    return row


def resize_ce_phase(torch, K):
    """K3 at the train step's shape and at odd shapes, f32, TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = [resize_ce_case(K, torch, gen, (BATCH, 128, 256, CLASSES), 8, 0.0,
                           True, timed=True),
            resize_ce_case(K, torch, gen, (2, 13, 21, CLASSES), 3, 0.1, False),
            resize_ce_case(K, torch, gen, (1, 9, 7, 5), 16, 0.0, True),
            resize_ce_case(K, torch, gen, (2, 13, 21, CLASSES), 3, 0.1, True,
                           scale=100.0),
            resize_ce_case(K, torch, gen, (1, 7, 12, 64), 4, 0.1, True),
            resize_ce_case(K, torch, gen, (1, 8, 8, CLASSES), 8, 0.0, True,
                           all_ignored=True)]
    rows[0]["layer"] = "train loss tail"
    for row in rows:
        print("kernel", json.dumps(row))
    check(all(r["within_tol"] for r in rows),
          f"resize_ce_sums outside tolerance: {rows}")
    check(rows[0]["bit_identical"], "resize_ce_sums: two launches differ")
    return rows


def smooth_images(torch, F, gen, n, hw):
    """Seeded image-like batch: a random field at 1/32 resolution, upsampled,
    plus a little pixel noise, so images differ in their global means (iid
    noise would give every image the same pooled features)."""
    low = torch.randn((n, 3, hw[0] // 32, hw[1] // 32), generator=gen,
                      device=gen.device)
    x = F.interpolate(low, size=hw, mode="bilinear", align_corners=False)
    return x + 0.1 * torch.randn((n, 3, *hw), generator=gen, device=gen.device)


def seeded_model(torch, F, build_model, BatchNorm, seed: int,
                 arch: str = "fastscnn"):
    """``arch`` (19 classes) on the card: port init from a seeded
    generator, BN affines drawn from it too, running stats from one train
    pass at momentum 1 over a seeded batch, with each variance floored at
    VAR_FLOOR (random weights leave near-dead channels whose tiny batch
    variance would scale them by up to 1/sqrt(eps))."""
    from esn_tpu_torch.nn import set_dropout_generator
    gen = torch.Generator().manual_seed(seed)
    model = build_model(arch, CLASSES, device="cuda", generator=gen)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for bn in bns:
            bn.weight.copy_(torch.rand(bn.weight.shape, generator=gen) + 0.5)
            bn.bias.copy_(torch.randn(bn.bias.shape, generator=gen) * 0.1)
            bn.momentum = 1.0
        calib = smooth_images(torch, F, gen, 4, (512, 1024)).cuda()
        set_dropout_generator(model, torch.Generator(device="cuda")
                              .manual_seed(seed))    # the train-mode pass
        model.train()
        model(calib.contiguous(memory_format=torch.channels_last))
        for bn in bns:
            bn.momentum = 0.1
            bn.running_var.clamp_(min=VAR_FLOOR)
    return model.eval()


@contextlib.contextmanager
def plain_versions(K):
    """Route the model's and the loss's kernel calls to the kernels' plain
    versions (both look them up in ``esn_tpu_torch.ops.kernels`` at call
    time)."""
    names = {"fused_dsconv": K.dsconv_ref, "resize_argmax": K.resize_argmax_ref,
             "resize_ce_sums": K.resize_ce_sums_ref,
             "fused_cgblock_pre": K.cgblock_pre_ref}
    saved = {name: getattr(K, name) for name in names}
    for name, plain in names.items():
        setattr(K, name, plain)
    try:
        yield
    finally:
        for name, kernel in saved.items():
            setattr(K, name, kernel)


def compare_with_plain(torch, F, K, model, make_predict_step, images, dtype):
    """Predict with the kernels and with their plain versions, same model,
    same images; mismatch rate, and whether every mismatch is a near-tie:
    the two classes' f32 upsampled logits (plain run) lie within twice the
    largest low-res logit difference (itself bounded by LOWRES_DIFF_MAX)
    plus the argmax rounding gap."""
    name = str(dtype).split(".")[-1]
    predict = make_predict_step(model, compute_dtype=dtype)
    x = images.to(dtype=dtype, memory_format=torch.channels_last)
    with torch.inference_mode():
        y_kernel, pred_kernel = model.logits_lowres(x), predict(images)
        with plain_versions(K):
            y_plain, pred_plain = model.logits_lowres(x), predict(images)
        y_plain = y_plain.permute(0, 2, 3, 1)
        delta = float((y_kernel.permute(0, 2, 3, 1).float()
                       - y_plain.float()).abs().max())
        mismatch = pred_kernel != pred_plain
        gap, mag = upsampled_gap(torch, F, y_plain, 8, pred_kernel,
                                 pred_plain)
        near_ties = bool((gap <= 2 * delta + ARGMAX_GAP[name] * mag)
                         [mismatch].all())
    std = float(y_plain.float().std())
    row = {"model": type(model).__name__, "dtype": name,
           "batch": images.shape[0],
           "mismatch_rate": float(mismatch.float().mean()),
           "mismatch_max": PREDICT_MISMATCH_MAX[name],
           "lowres_logit_max_abs_diff": delta,
           "lowres_logit_std": std,
           "lowres_diff_max": LOWRES_DIFF_MAX[name] * std,
           "near_ties_only": near_ties}
    print("predict vs plain", json.dumps(row))
    check(row["mismatch_rate"] <= row["mismatch_max"]
          and delta <= row["lowres_diff_max"] and near_ties,
          f"predict disagrees with its plain versions: {row}")
    return row


def timed_predict(torch, predict, images, iters: int = 10) -> float:
    """Seconds per batch over ``iters`` calls after one warm-up call, host
    clock, synchronised."""
    predict(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        predict(images)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def predict_phase(torch, F, K, build_model, BatchNorm, make_predict_step,
                  arch, want_launches):
    """``arch`` predict at bf16 b8 3x1024x2048: the launch counts of one
    predict (``want_launches``), the class map, agreement with the plain
    versions in bf16 and f32, img/s with the kernels and with the plain
    versions, peak memory."""
    model = seeded_model(torch, F, build_model, BatchNorm, seed=0, arch=arch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = smooth_images(torch, F, gen, BATCH, IMAGE_HW)
    predict = make_predict_step(model, compute_dtype=torch.bfloat16)
    predict(images)                                   # warm-up
    torch.cuda.synchronize()

    # the main path, once, with the launch counts from zero
    K.reset_launches()
    pred = predict(images)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"{arch} predict launches", json.dumps(launches))
    check(launches == want_launches,
          f"{arch}: launch counts per predict {launches}")
    check(tuple(pred.shape) == (BATCH, *IMAGE_HW) and pred.dtype == torch.int32,
          f"predict output {tuple(pred.shape)} {pred.dtype}")
    lo, hi = int(pred.min()), int(pred.max())
    check(0 <= lo and hi < CLASSES, f"predict classes in [{lo}, {hi}]")
    n_classes = int((torch.bincount(pred.flatten().long(),
                                    minlength=CLASSES) > 0).sum())
    print(f"{arch} predict output int32 {tuple(pred.shape)}, classes in "
          f"[{lo}, {hi}], {n_classes} seen")

    compared = [compare_with_plain(torch, F, K, model, make_predict_step,
                                   images, torch.bfloat16)]
    torch.backends.cudnn.allow_tf32 = False
    compared.append(compare_with_plain(torch, F, K, model, make_predict_step,
                                       images, torch.float32))
    torch.backends.cudnn.allow_tf32 = True    # the library default again

    # kernels against plain versions, in turns: plain, kernel, kernel, plain
    torch.cuda.reset_peak_memory_stats()
    times = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "plain":
            with plain_versions(K):
                times[which].append(timed_predict(torch, predict, images))
        else:
            times[which].append(timed_predict(torch, predict, images))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = {k: 1e3 * sum(v) / len(v) for k, v in times.items()}
    img_s = {k: BATCH / (v / 1e3) for k, v in ms.items()}
    print(f"{arch} predict bf16 b{BATCH} {IMAGE_HW[1]}x{IMAGE_HW[0]}: "
          f"{img_s['kernel']:.2f} img/s ({ms['kernel']:.3f} ms/batch) with "
          f"the kernels, {img_s['plain']:.2f} img/s ({ms['plain']:.3f} "
          f"ms/batch) with the plain versions; peak {peak_gb:.2f} GB")
    return {"launches": launches, "classes_seen": n_classes,
            "compared": compared, "img_per_s": img_s["kernel"],
            "plain_img_per_s": img_s["plain"], "ms_per_batch": ms,
            "peak_gb": peak_gb, "batch": BATCH}


def learnable_labels(torch, F, gen, n, hw):
    """Seeded labels a network can fit: the argmax of a smooth random
    19-class field (1/16 resolution, upsampled), with a band of ignored
    rows across the middle."""
    low = torch.randn((n, CLASSES, hw[0] // 16, hw[1] // 16), generator=gen,
                      device=gen.device)
    field = F.interpolate(low, size=hw, mode="bilinear", align_corners=False)
    labels = field.argmax(1).to(torch.int32)
    del field
    labels[:, hw[0] // 2 - 16:hw[0] // 2 + 16] = IGNORE
    return labels


def class_weights(torch, labels):
    """``1 / ln(1.10 + p_c)`` from the labels' class histogram: the
    reference's formula (esn_tpu/data/inform.py), written out here."""
    hist = torch.bincount(labels[labels != IGNORE].long(),
                          minlength=CLASSES).double()
    return (1.0 / torch.log(1.10 + hist / hist.sum())).float()


def config5_loss(cw):
    """The reference's config-5 loss: class-weighted CE plus OHEM, both on
    the same full-resolution NHWC logits."""
    from esn_tpu_torch.train.losses import cross_entropy, ohem_cross_entropy

    def loss(logits, labels):
        return (cross_entropy(logits, labels, num_classes=CLASSES,
                              class_weights=cw, ignore_index=IGNORE)
                + ohem_cross_entropy(logits, labels, num_classes=CLASSES,
                                     ignore_index=IGNORE))
    return loss


def config5_step(torch, model, opt, cw, dtype):
    """adam + poly on ``opt`` with the config-5 loss on the model's own
    full-resolution logits (``fwd_method=None``); dropout masks from a
    seeded generator on the model's device."""
    from esn_tpu_torch.train.losses import fused_resize_ce_spec
    from esn_tpu_torch.train.schedules import build_schedule
    from esn_tpu_torch.train.step import make_train_step
    check(fused_resize_ce_spec(model, "ohem") == (None, None),
          "OHEM must not take the fused resize-CE route")
    device = next(model.parameters()).device
    return make_train_step(
        model, config5_loss(cw.to(device)), opt,
        schedule=build_schedule("poly", TRAIN_LR, TRAIN_TOTAL_STEPS),
        compute_dtype=dtype, fwd_method=None,
        generator=torch.Generator(device=device).manual_seed(3))


def train_step(torch, model, opt, cw, dtype):
    """The default of train.py on a resize-tail model, through the port's
    entry points: class-weighted CE through logits_lowres (the loss owns
    the x8 upsample), poly lr on ``opt``; dropout masks from a seeded
    generator on the card."""
    from esn_tpu_torch.train.losses import fused_resize_ce_spec
    from esn_tpu_torch.train.schedules import build_schedule
    from esn_tpu_torch.train.step import make_train_step
    fused, method = fused_resize_ce_spec(model, "ce")
    loss = functools.partial(fused, num_classes=CLASSES, class_weights=cw,
                             ignore_index=IGNORE)
    return make_train_step(
        model, loss, opt,
        schedule=build_schedule("poly", TRAIN_LR, TRAIN_TOTAL_STEPS),
        compute_dtype=dtype, fwd_method=method,
        generator=torch.Generator(device="cuda").manual_seed(3))


def train_setup(torch, F, arch: str = "fastscnn"):
    """``arch`` (19 classes) on the card (port init, seed 0), adam, and
    one seeded batch: smooth images, learnable labels, their class
    weights."""
    from esn_tpu_torch.models import build_model
    from esn_tpu_torch.train.optimizers import build_optimizer
    model = build_model(arch, CLASSES, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    opt = build_optimizer("adam", model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(3)
    images = smooth_images(torch, F, gen, BATCH, IMAGE_HW)
    labels = learnable_labels(torch, F, gen, BATCH, IMAGE_HW)
    return model, opt, {"image": images, "label": labels}, class_weights(
        torch, labels)


def compare_train_step(torch, K, model, opt, batch, cw):
    """One f32 step (TF32 off) from copies of the same model and optimizer,
    with the kernel and with the plain versions: loss and per-leaf
    gradients."""
    runs = {}
    for which in ("kernel", "plain"):
        m = copy.deepcopy(model)
        o = type(opt)(m.parameters())
        o.load_state_dict(opt.state_dict())
        step = train_step(torch, m, o, cw, torch.float32)
        with plain_versions(K) if which == "plain" else contextlib.nullcontext():
            loss = float(step(batch)["loss"])
        runs[which] = (loss, {n: p.grad.detach().clone()
                              for n, p in m.named_parameters()})
        del m, o, step
    (loss, grads), (loss0, grads0) = runs["kernel"], runs["plain"]
    diff = {n: float(torch.linalg.norm(grads[n] - g0))
            for n, g0 in grads0.items()}
    norm = {n: float(torch.linalg.norm(g0)) for n, g0 in grads0.items()}
    excess = {n: diff[n] - TRAIN_GRAD_REL * norm[n] - TRAIN_GRAD_ABS
              for n in diff}
    worst = max(excess, key=excess.get)
    rel = {n: diff[n] / norm[n] for n in diff if norm[n] > 1e3 * TRAIN_GRAD_ABS}
    worst_rel = max(rel, key=rel.get)
    row = {"dtype": "float32", "loss": loss, "plain_loss": loss0,
           "loss_rel_diff": abs(loss - loss0) / abs(loss0),
           "loss_rel_max": TRAIN_LOSS_REL, "grad_rel_l2_max": rel[worst_rel],
           "grad_rel_l2_worst_leaf": worst_rel,
           "grad_rel_bound": TRAIN_GRAD_REL, "grad_abs_bound": TRAIN_GRAD_ABS,
           "worst_leaf_by_bound": worst, "worst_leaf_diff": diff[worst],
           "worst_leaf_norm": norm[worst]}
    print("train step vs plain", json.dumps(row))
    check(row["loss_rel_diff"] <= TRAIN_LOSS_REL and excess[worst] <= 0,
          f"train step disagrees with its plain versions: {row}")
    return row


def timed_steps(torch, step, batch, iters: int = 10) -> float:
    """Seconds per train step over ``iters`` steps after one warm-up step,
    host clock, synchronised."""
    step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def train_phase(torch, F, K, BatchNorm):
    """Fast-SCNN-19 training at bf16 b8 3x1024x2048 through the port's
    entry points: launch counts, a falling loss over five steps on one
    batch, BN running stats that move, the f32 step against the plain
    versions, and the step's time with the kernel and with the plain
    versions."""
    model, opt, batch, cw = train_setup(torch, F)
    torch.backends.cudnn.allow_tf32 = False
    compared = compare_train_step(torch, K, model, opt, batch, cw)
    torch.backends.cudnn.allow_tf32 = True    # the library default again

    step = train_step(torch, model, opt, cw, torch.bfloat16)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    stats0 = [m.running_mean.clone() for m in bns]
    # the main path, five steps, with the launch counts from zero
    K.reset_launches()
    losses = [float(step(batch)["loss"]) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print("train launches", json.dumps(launches))
    print("train losses", json.dumps(losses))
    check(launches == {"dsconv": 0, "resize_argmax": 0,
                       "resize_ce_fwd": TRAIN_STEPS,
                       "resize_ce_bwd": TRAIN_STEPS, "cgblock": 0},
          f"launch counts over {TRAIN_STEPS} train steps {launches}")
    check(all(math.isfinite(v) for v in losses), f"train losses {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    moved = sum(not torch.equal(m.running_mean, m0)
                for m, m0 in zip(bns, stats0))
    check(moved == len(bns), f"BN running stats moved in {moved} of "
          f"{len(bns)} layers")

    # kernel against plain versions, in turns: plain, kernel, kernel, plain
    torch.cuda.reset_peak_memory_stats()
    times = {"kernel": [], "plain": []}
    peak = {}
    for which in ("plain", "kernel", "kernel", "plain"):
        torch.cuda.reset_peak_memory_stats()
        with plain_versions(K) if which == "plain" else contextlib.nullcontext():
            times[which].append(timed_steps(torch, step, batch))
        peak[which] = max(peak.get(which, 0.0),
                          torch.cuda.max_memory_allocated() / 1e9)
    ms = {k: 1e3 * sum(v) / len(v) for k, v in times.items()}
    img_s = {k: BATCH / (v / 1e3) for k, v in ms.items()}
    print(f"train bf16 b{BATCH} {IMAGE_HW[1]}x{IMAGE_HW[0]}: "
          f"{img_s['kernel']:.2f} img/s ({ms['kernel']:.3f} ms/step) with "
          f"the kernel, {img_s['plain']:.2f} img/s ({ms['plain']:.3f} "
          f"ms/step) with the plain versions; peak {peak['kernel']:.2f} GB "
          f"vs {peak['plain']:.2f} GB")
    return {"launches": launches, "losses": losses, "bn_layers_moved": moved,
            "compared": compared, "ms_per_step": ms, "img_per_s": img_s,
            "peak_gb": peak, "batch": BATCH, "class_weights": cw.tolist()}


def interleaved_phase(torch, F, K, build_model, make_predict_step, arch,
                      want_launches, batch_size: int = 2):
    """A predict step built before a train step of the same model and
    called after it, bf16 at 3x1024x2048: the predict runs in eval mode
    (``want_launches``, BN running statistics bit for bit as the step left
    them, the class map of a predict of the model put in eval mode by
    hand). Also the host time of what a predict call pays for that: a
    read of every module's ``training`` flag, and one ``model.eval()`` on the
    first call after a train step."""
    from esn_tpu_torch.train.optimizers import build_optimizer
    model = build_model(arch, CLASSES, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    predict = make_predict_step(model, compute_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(5)
    images = smooth_images(torch, F, gen, batch_size, IMAGE_HW)
    labels = learnable_labels(torch, F, gen, batch_size, IMAGE_HW)
    step = train_step(torch, model, build_optimizer("adam", model.parameters()),
                      class_weights(torch, labels), torch.bfloat16)
    loss = float(step({"image": images, "label": labels})["loss"])
    check(model.training and math.isfinite(loss),
          f"{arch}: after a train step training={model.training} loss={loss}")
    stats = {name: buf.clone() for name, buf in model.named_buffers()}
    K.reset_launches()
    pred = predict(images)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"{arch} predict after a train step: launches", json.dumps(launches))
    check(launches == want_launches,
          f"{arch}: predict after a train step launched {launches}")
    check(not any(m.training for m in model.modules()),
          f"{arch}: predict left modules in train mode")
    moved = [name for name, buf in model.named_buffers()
             if not torch.equal(buf, stats[name])]
    check(not moved, f"{arch}: predict moved the buffers {moved[:5]}")
    model.eval()
    with torch.inference_mode():
        want = model.predict(images.to(dtype=torch.bfloat16,
                                       memory_format=torch.channels_last))
    check(bool(torch.equal(pred, want)),
          f"{arch}: predict after a train step differs from an eval-mode "
          f"predict at {float((pred != want).float().mean()):.3g} of pixels")
    modules = list(model.modules())
    host_ms = {}
    for name, fn in (("eval", model.eval),
                     ("check", lambda: any(m.training for m in modules))):
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        host_ms[name] = 1e3 * (time.perf_counter() - t0) / 100
    print(f"{arch}: {len(modules)} modules, host time of model.eval() "
          f"{host_ms['eval']:.4f} ms (the first predict after a train step), "
          f"of the mode check {host_ms['check']:.4f} ms (every predict)")
    return {"launches": launches, "train_loss": loss,
            "modules": len(modules), "eval_call_host_ms": host_ms["eval"],
            "mode_check_host_ms": host_ms["check"], "batch": batch_size}


def planted_ties(torch, gen, shape, dtype):
    """Seeded values with ties inside 2x2 windows: a constant block, two
    values that alternate, and, once rounded to bf16, a block of values
    that lie within one bf16 step of each other."""
    x = torch.randn(shape, generator=gen)
    x[:, :, 2:10, 4:20] = 0.75
    x[:, :, 10:12, 0:4] = torch.tensor([[-1.0, 2.0, 2.0, -1.0],
                                        [2.0, 2.0, -3.0, 2.0]])
    x[:, :, 12:20, 0:16] = 1.0 + 0.004 * torch.rand((8, 16), generator=gen)
    return x.to(dtype)


def pool_phase(torch):
    """``max_pool2d_with_indices_2x2`` then ``max_unpool2d_2x2`` on the
    card against the CPU, bit for bit: values, indices (ties go to the
    first window position), the unpooled tensor and its memory format;
    contiguous and channels_last, f32 and bf16, an even size and an odd
    one with ``output_size``."""
    from esn_tpu_torch.ops import pooling as P
    gen = torch.Generator().manual_seed(6)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for channels_last in (False, True):
            for hw in ((64, 96), (37, 53)):
                x = planted_ties(torch, gen, (2, 16, *hw), dtype)
                if channels_last:
                    x = x.contiguous(memory_format=torch.channels_last)
                fmt = (torch.channels_last if channels_last
                       else torch.contiguous_format)
                xc = x.cuda()
                check(xc.is_contiguous(memory_format=fmt), "pool input format")
                v0, i0 = P.max_pool2d_with_indices_2x2(x)
                v1, i1 = P.max_pool2d_with_indices_2x2(xc)
                u0 = P.max_unpool2d_2x2(v0, i0, hw)
                u1 = P.max_unpool2d_2x2(v1, i1, hw)
                w = 2 * (hw[1] // 2)
                tied = i0[:, :, 1:5, 2:10]     # the constant block's windows
                first = (torch.arange(1, 5)[:, None] * 2 * w
                         + torch.arange(2, 10)[None, :] * 2)
                windows = x[:, :, :2 * (hw[0] // 2), :w].unflatten(
                    2, (-1, 2)).unflatten(4, (-1, 2))
                n_tied = int(((windows == windows.amax((3, 5), keepdim=True))
                              .sum((3, 5)) > 1).sum())
                row = {"dtype": str(dtype).split(".")[-1],
                       "channels_last": channels_last, "hw": list(hw),
                       "tied_windows": n_tied,
                       "values_equal": bool(torch.equal(v0, v1.cpu())),
                       "indices_equal": bool(torch.equal(i0, i1.cpu())),
                       "unpool_equal": bool(torch.equal(u0, u1.cpu())),
                       "first_position": bool((tied == first).all()),
                       "unpool_shape_ok": tuple(u1.shape[2:]) == hw,
                       "format_kept": bool(P.max_unpool2d_2x2(v1, i1)
                                           .is_contiguous(memory_format=fmt))}
                rows.append(row)
                print("pool/unpool", json.dumps(row))
    bad = [r for r in rows if not all(v for k, v in r.items() if k not in
                                      ("dtype", "channels_last", "hw"))]
    check(not bad, f"pool/unpool on the card differs from the CPU: {bad}")
    return rows


def enet_predict_phase(torch, F, K, build_model, BatchNorm,
                       make_predict_step):
    """ENet-19 predict at bf16 b8 3x1024x2048: output, launch counts (all
    0), img/s; the f32 predict of a 2-image slice on the card against the
    CPU. Returns the model too (the eval phase scores it)."""
    model = seeded_model(torch, F, build_model, BatchNorm, seed=0, arch="enet")
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = smooth_images(torch, F, gen, BATCH, IMAGE_HW)
    predict = make_predict_step(model, compute_dtype=torch.bfloat16)
    predict(images)                                   # warm-up
    torch.cuda.synchronize()
    K.reset_launches()
    pred = predict(images)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print("enet predict launches", json.dumps(launches),
          "(no kernel lies on ENet's path)")
    check(not any(launches.values()), f"enet predict launched {launches}")
    check(tuple(pred.shape) == (BATCH, *IMAGE_HW) and pred.dtype == torch.int32,
          f"enet predict output {tuple(pred.shape)} {pred.dtype}")
    lo, hi = int(pred.min()), int(pred.max())
    check(0 <= lo and hi < CLASSES, f"enet predict classes in [{lo}, {hi}]")
    n_classes = int((torch.bincount(pred.flatten().long(),
                                    minlength=CLASSES) > 0).sum())
    check(n_classes > 3, f"enet predict saw {n_classes} classes")
    print(f"enet predict output int32 {tuple(pred.shape)}, classes in "
          f"[{lo}, {hi}], {n_classes} seen")

    # the card against the CPU: f32, TF32 off, a 2-image slice
    torch.backends.cudnn.allow_tf32 = False
    x = images[:2].contiguous(memory_format=torch.channels_last)
    cpu_model = copy.deepcopy(model).to("cpu")
    indices = {"cuda": [], "cpu": []}     # of down1 and down2, in order
    hooks = [block.register_forward_hook(
        lambda _m, _i, out, dev=dev: indices[dev].append(out[1].cpu()))
        for dev, m in (("cuda", model), ("cpu", cpu_model))
        for block in (m.down1, m.down2)]
    with torch.inference_mode():
        logits = model(x).cpu()
        t0 = time.perf_counter()
        logits0 = cpu_model(x.cpu())
        for hook in hooks:
            hook.remove()
        got = make_predict_step(model)(x).cpu()
        want = make_predict_step(cpu_model)(x.cpu())
        cpu_s = time.perf_counter() - t0
    torch.backends.cudnn.allow_tf32 = True    # the library default again
    # the decoder's receptive field of each window whose index differs
    flips, field = [], torch.zeros(logits.shape[0], *logits.shape[2:],
                                   dtype=torch.bool)
    for i_card, i_cpu, cell, radius in zip(indices["cuda"], indices["cpu"],
                                           (4, 8), (2, 3)):
        differ = i_card != i_cpu
        flips.append(int(differ.sum()))
        m = F.max_pool2d(differ.any(1, keepdim=True).float(), 2 * radius + 1,
                         1, radius)
        field |= F.interpolate(m, scale_factor=cell)[:, 0] > 0
    windows = sum(i.numel() for i in indices["cpu"])
    std = float(logits0.std())
    tol = ENET_LOGIT_DIFF_MAX * std
    diff = (logits - logits0).abs()
    mismatch = got != want
    a = logits0.gather(1, got.long()[:, None]).squeeze(1)
    b = logits0.gather(1, want.long()[:, None]).squeeze(1)
    near_ties = bool(((a - b).abs() <= 2 * tol)[mismatch & ~field].all())
    compared = {"dtype": "float32", "batch": 2,
                "mismatch_rate": float(mismatch.float().mean()),
                "mismatch_max": ENET_MISMATCH_MAX,
                "pool_indices_differ": flips, "pool_windows": windows,
                "flips_max": ENET_FLIPS_MAX * windows,
                "pixels_in_their_fields": int(field.sum()),
                "logit_std": std, "logit_diff_tol": tol,
                "logit_diff_median": float(diff.flatten()[::97].median()),
                "logit_max_abs_diff": float(diff.max()),
                "logit_max_abs_diff_elsewhere": float(
                    diff.amax(1)[~field].max()),
                "near_ties_only_elsewhere": near_ties, "cpu_seconds": cpu_s}
    print("enet predict, the card vs the CPU", json.dumps(compared))
    check(compared["mismatch_rate"] <= ENET_MISMATCH_MAX
          and sum(flips) <= compared["flips_max"]
          and compared["logit_max_abs_diff_elsewhere"] <= tol and near_ties,
          f"enet predict on the card disagrees with the CPU: {compared}")

    torch.cuda.reset_peak_memory_stats()
    sec = timed_predict(torch, predict, images, iters=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"enet predict bf16 b{BATCH} {IMAGE_HW[1]}x{IMAGE_HW[0]}: "
          f"{BATCH / sec:.2f} img/s ({1e3 * sec:.3f} ms/batch); peak "
          f"{peak_gb:.2f} GB")
    return model, images, {
        "launches": launches, "classes_seen": n_classes, "compared": compared,
        "img_per_s": BATCH / sec, "ms_per_batch": 1e3 * sec,
        "peak_gb": peak_gb, "batch": BATCH}


def compare_step_with_cpu(torch, model, opt, batch, cw):
    """One f32 config-5 step (TF32 off) on a small slice of the batch,
    from copies of the same model and optimizer on the card and on the
    CPU, dropout off: loss and per-leaf gradients."""
    from esn_tpu_torch.nn import Dropout
    h, w = ENET_SLICE_HW
    runs = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev)
        for sub in m.modules():       # the two devices draw other masks
            if isinstance(sub, Dropout):
                sub.rate = 0.0
        o = type(opt)(m.parameters())
        o.load_state_dict(opt.state_dict())
        step = config5_step(torch, m, o, cw, torch.float32)
        loss = float(step({"image": batch["image"][:2, :, :h, :w].to(dev),
                           "label": batch["label"][:2, :h, :w].to(dev)})
                     ["loss"])
        runs[dev] = (loss, {n: p.grad.detach().cpu()
                            for n, p in m.named_parameters()})
        del m, o, step
    (loss, grads), (loss0, grads0) = runs["cuda"], runs["cpu"]
    diff = {n: float(torch.linalg.norm(grads[n] - g0))
            for n, g0 in grads0.items()}
    norm = {n: float(torch.linalg.norm(g0)) for n, g0 in grads0.items()}
    excess = {n: diff[n] - ENET_GRAD_REL * norm[n] - TRAIN_GRAD_ABS
              for n in diff}
    worst = max(excess, key=excess.get)
    rel = {n: diff[n] / norm[n] for n in diff if norm[n] > 1e3 * TRAIN_GRAD_ABS}
    worst_rel = max(rel, key=rel.get)
    row = {"dtype": "float32", "slice": [2, 3, h, w], "loss": loss,
           "cpu_loss": loss0, "loss_rel_diff": abs(loss - loss0) / abs(loss0),
           "loss_rel_max": TRAIN_LOSS_REL, "grad_rel_l2_max": rel[worst_rel],
           "grad_rel_l2_median": sorted(rel.values())[len(rel) // 2],
           "grad_rel_l2_worst_leaf": worst_rel,
           "grad_rel_bound": ENET_GRAD_REL, "grad_abs_bound": TRAIN_GRAD_ABS,
           "worst_leaf_by_bound": worst, "worst_leaf_diff": diff[worst],
           "worst_leaf_norm": norm[worst]}
    print("enet train step, the card vs the CPU", json.dumps(row))
    check(row["loss_rel_diff"] <= TRAIN_LOSS_REL and excess[worst] <= 0,
          f"enet train step on the card disagrees with the CPU: {row}")
    return row


def config5_train(torch, K, BatchNorm, name, model, step, batch):
    """Five config-5 steps on one batch with the launch counts from zero:
    no kernel launches, a falling loss, BN running stats that move, finite
    gradients on every leaf."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    stats0 = [m.running_mean.clone() for m in bns]
    K.reset_launches()
    losses = [float(step(batch)["loss"]) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"{name} CE + OHEM train launches", json.dumps(launches),
          "(resize_ce 0: OHEM takes the step off the fused resize-CE "
          "route)" if name == "fastscnn" else "(no kernel lies on its path)")
    print(f"{name} CE + OHEM train losses", json.dumps(losses))
    check(not any(launches.values()),
          f"{name}: a CE + OHEM step launched {launches}")
    check(all(math.isfinite(v) for v in losses), f"{name} losses {losses}")
    check(losses[-1] < losses[0], f"{name} loss did not fall: {losses}")
    moved = sum(not torch.equal(m.running_mean, m0)
                for m, m0 in zip(bns, stats0))
    check(moved == len(bns), f"{name}: BN running stats moved in {moved} of "
          f"{len(bns)} layers")
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    check(not bad, f"{name}: no finite gradient on {bad[:5]}")
    return {"launches": launches, "losses": losses, "bn_layers_moved": moved,
            "leaves": sum(1 for _ in model.parameters())}


def enet_train_phase(torch, F, K, BatchNorm):
    """ENet-19 training at bf16 b8 3x1024x2048 with the config-5 loss: the
    f32 step of a slice against the CPU, five steps, ms/step, peak
    memory."""
    model, opt, batch, cw = train_setup(torch, F, "enet")
    torch.backends.cudnn.allow_tf32 = False
    compared = compare_step_with_cpu(torch, model, opt, batch, cw)
    torch.backends.cudnn.allow_tf32 = True    # the library default again
    step = config5_step(torch, model, opt, cw, torch.bfloat16)
    result = config5_train(torch, K, BatchNorm, "enet", model, step, batch)
    torch.cuda.reset_peak_memory_stats()
    sec = timed_steps(torch, step, batch, iters=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"enet train (CE + OHEM) bf16 b{BATCH} {IMAGE_HW[1]}x{IMAGE_HW[0]}:"
          f" {BATCH / sec:.2f} img/s ({1e3 * sec:.3f} ms/step); peak "
          f"{peak_gb:.2f} GB")
    result.update(compared=compared, ms_per_step=1e3 * sec,
                  img_per_s=BATCH / sec, peak_gb=peak_gb, batch=BATCH)
    return result


def enet_eval_phase(torch, K, build_model, model, images):
    """``make_eval_step`` on the predict phase's ENet: labels made from
    its own prediction, with a band of ignored rows, and ``valid`` =
    EVAL_VALID of 8 give a diagonal confusion matrix over the non-ignored
    pixels of the first rows and mIoU 1 over the present classes. Then an
    eval step built before a train step and called after it: eval mode,
    the buffers untouched, the class map of an eval-mode predict."""
    from esn_tpu_torch.train.metrics import iou_from_confusion
    from esn_tpu_torch.train.optimizers import build_optimizer
    from esn_tpu_torch.train.step import make_eval_step
    evaluate = make_eval_step(model, CLASSES, ignore_index=IGNORE,
                              compute_dtype=torch.bfloat16)
    pred0, _ = evaluate({"image": images, "label": torch.zeros(
        (BATCH, *IMAGE_HW), dtype=torch.int32, device="cuda")})
    labels = pred0.clone()
    labels[:, IMAGE_HW[0] // 2 - 16:IMAGE_HW[0] // 2 + 16] = IGNORE
    K.reset_launches()
    pred, cm = evaluate({"image": images, "label": labels,
                         "valid": EVAL_VALID})
    torch.cuda.synchronize()
    check(not any(K.LAUNCHES.values()), f"enet eval launched {K.LAUNCHES}")
    check(bool(torch.equal(pred, pred0)), "two eval steps differ")
    counted = int((labels[:EVAL_VALID] != IGNORE).sum())
    iou, miou = iou_from_confusion(cm)
    present = int((cm.sum(0) + cm.sum(1) > 0).sum())
    row = {"cm_sum": int(cm.sum()), "pixels_counted": counted,
           "off_diagonal": int(cm.sum() - torch.diagonal(cm).sum()),
           "classes_present": present, "miou": float(miou),
           "valid": EVAL_VALID, "cm_dtype": str(cm.dtype)}
    print("enet eval", json.dumps(row))
    check(tuple(cm.shape) == (CLASSES, CLASSES) and cm.dtype == torch.int64
          and row["cm_sum"] == counted and row["off_diagonal"] == 0
          and present > 3 and row["miou"] == 1.0,
          f"enet eval step: {row}")
    sec = timed_predict(torch, lambda x: evaluate(
        {"image": x, "label": labels, "valid": EVAL_VALID}), images, iters=5)
    row.update(ms_per_batch=1e3 * sec, img_per_s=BATCH / sec)
    print(f"enet eval step bf16 b{BATCH}: {BATCH / sec:.2f} img/s "
          f"({1e3 * sec:.3f} ms/batch)")

    # built before a train step, called after it (batch 2)
    fresh = build_model("enet", CLASSES, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    evaluate = make_eval_step(fresh, CLASSES, ignore_index=IGNORE,
                              compute_dtype=torch.bfloat16)
    small = {"image": images[:2], "label": labels[:2]}
    cw = class_weights(torch, small["label"])
    step = config5_step(torch, fresh,
                        build_optimizer("adam", fresh.parameters()), cw,
                        torch.bfloat16)
    loss = float(step(small)["loss"])
    check(fresh.training and math.isfinite(loss),
          f"enet: after a train step training={fresh.training} loss={loss}")
    stats = {name: buf.clone() for name, buf in fresh.named_buffers()}
    pred, cm = evaluate(small)
    check(not any(m.training for m in fresh.modules()),
          "enet: the eval step left modules in train mode")
    moved = [name for name, buf in fresh.named_buffers()
             if not torch.equal(buf, stats[name])]
    check(not moved, f"enet: the eval step moved the buffers {moved[:5]}")
    fresh.eval()
    with torch.inference_mode():
        want = fresh.predict(small["image"].to(
            dtype=torch.bfloat16, memory_format=torch.channels_last))
    check(bool(torch.equal(pred, want)),
          "enet: eval after a train step differs from an eval-mode predict")
    check(int(cm.sum()) == int((small["label"] != IGNORE).sum()),
          "enet: eval after a train step miscounts")
    print("enet eval after a train step: eval mode, buffers untouched")
    row["after_train_loss"] = loss
    return row


def fastscnn_config5_phase(torch, F, K, BatchNorm):
    """Fast-SCNN-19 with the config-5 loss at bf16 b8 3x1024x2048,
    ``fwd_method=None``: five steps, then its time and peak memory in
    turns with the weighted-CE step through the fused resize-CE kernel
    (the price of leaving the fused tail)."""
    model, opt, batch, cw = train_setup(torch, F)
    step = config5_step(torch, model, opt, cw, torch.bfloat16)
    result = config5_train(torch, K, BatchNorm, "fastscnn", model, step, batch)
    fused = train_step(torch, model, opt, cw, torch.bfloat16)
    times, peak = {"ce": [], "ce_ohem": []}, {}
    for which in ("ce", "ce_ohem", "ce_ohem", "ce"):
        torch.cuda.reset_peak_memory_stats()
        times[which].append(timed_steps(
            torch, fused if which == "ce" else step, batch, iters=5))
        peak[which] = max(peak.get(which, 0.0),
                          torch.cuda.max_memory_allocated() / 1e9)
    ms = {k: 1e3 * sum(v) / len(v) for k, v in times.items()}
    print(f"fastscnn train bf16 b{BATCH} {IMAGE_HW[1]}x{IMAGE_HW[0]}: CE + "
          f"OHEM on full-resolution logits {ms['ce_ohem']:.3f} ms/step, peak "
          f"{peak['ce_ohem']:.2f} GB; weighted CE through the fused resize-CE "
          f"kernel {ms['ce']:.3f} ms/step, peak {peak['ce']:.2f} GB")
    result.update(ms_per_step=ms, peak_gb=peak, batch=BATCH)
    return result


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "esn_tpu_torch").is_dir():
        print(f"chip_smoke: no esn_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import torch.nn.functional as F

    from esn_tpu_torch.models import build_model
    from esn_tpu_torch.nn import BatchNorm
    from esn_tpu_torch.ops import kernels as K
    from esn_tpu_torch.ops.kernels import _build
    from esn_tpu_torch.train.step import make_predict_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)

    info = _build.build()
    _build.library()
    print(f"build: {info.path.relative_to(REPO)} in {info.seconds:.1f} s "
          f"({'compiled' if info.built else 'cached'})")
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ptxas.log").write_text(info.log)

    dsconv_rows, argmax_rows = kernel_phase(torch, F, K)
    ce_rows = resize_ce_phase(torch, K)
    cg_rows = cgblock_phase(torch, K)
    result = predict_phase(
        torch, F, K, build_model, BatchNorm, make_predict_step, "fastscnn",
        {"dsconv": 4, "resize_argmax": 1, "resize_ce_fwd": 0,
         "resize_ce_bwd": 0, "cgblock": 0})
    trained = train_phase(torch, F, K, BatchNorm)
    cgnet = predict_phase(
        torch, F, K, build_model, BatchNorm, make_predict_step, "cgnet",
        {"dsconv": 0, "resize_argmax": 1, "resize_ce_fwd": 0,
         "resize_ce_bwd": 0, "cgblock": 22})

    interleaved = {
        "fastscnn": interleaved_phase(
            torch, F, K, build_model, make_predict_step, "fastscnn",
            result["launches"]),
        "cgnet": interleaved_phase(
            torch, F, K, build_model, make_predict_step, "cgnet",
            cgnet["launches"])}

    pool_rows = pool_phase(torch)
    enet_model, enet_images, enet_predict = enet_predict_phase(
        torch, F, K, build_model, BatchNorm, make_predict_step)
    enet_eval = enet_eval_phase(torch, K, build_model, enet_model,
                                enet_images)
    del enet_model, enet_images
    torch.cuda.empty_cache()
    enet_train = enet_train_phase(torch, F, K, BatchNorm)
    torch.cuda.empty_cache()
    fastscnn_config5 = fastscnn_config5_phase(torch, F, K, BatchNorm)

    ds_main = [r for r in dsconv_rows
               if r["dtype"] == "bfloat16" and r["layer"] != "odd"]
    tail = next(r for r in argmax_rows
                if r["dtype"] == "bfloat16" and r["layer"] == "predict tail")
    cg_main = [r for r in cg_rows
               if r["dtype"] == "bfloat16" and r["layer"] != "odd"]
    def by(rows):
        return max(rows, key=lambda r: r["bound_ms"])["bound_by"]

    # library_ms: no single PyTorch call computes any of the four (K1 is
    # interpolate then argmax, K3 interpolate then cross_entropy, K2 and
    # K4 chains of convolutions)
    kernels = [
        {"name": "fused_dsconv", "route": "cuda",
         "source": "esn_tpu_torch/csrc/dsconv.cu",
         "replaces": "esn_tpu/ops/pallas/dsconv.py:198",
         "launches": result["launches"]["dsconv"],
         "max_abs_err": max(r["max_abs_err"] for r in ds_main),
         "ms": sum(r["ms"] for r in ds_main),
         "plain_ms": sum(r["plain_ms"] for r in ds_main),
         "bound_ms": sum(r["bound_ms"] for r in ds_main),
         "bound_by": by(ds_main), "library_ms": None},
        {"name": "resize_argmax", "route": "cuda",
         "source": "esn_tpu_torch/csrc/resize_argmax.cu",
         "replaces": "esn_tpu/ops/pallas/resize_argmax.py:123",
         "launches": result["launches"]["resize_argmax"],
         "max_abs_err": tail["max_abs_err"],
         "ms": tail["ms"], "plain_ms": tail["plain_ms"],
         "bound_ms": tail["bound_ms"], "bound_by": tail["bound_by"],
         "library_ms": None},
        {"name": "resize_ce_sums", "route": "cuda",
         "source": "esn_tpu_torch/csrc/resize_ce.cu",
         "replaces": "esn_tpu/ops/pallas/resize_ce.py:199,237",
         "launches": (trained["launches"]["resize_ce_fwd"]
                      + trained["launches"]["resize_ce_bwd"]),
         "max_abs_err": ce_rows[0]["dz_max_abs_err"],
         "ms": ce_rows[0]["ms"], "plain_ms": ce_rows[0]["plain_ms"],
         "bound_ms": ce_rows[0]["bound_ms"],
         "bound_by": ce_rows[0]["bound_by"], "library_ms": None},
        {"name": "fused_cgblock_pre", "route": "cuda",
         "source": "esn_tpu_torch/csrc/cgblock.cu",
         "replaces": "esn_tpu/ops/pallas/cgblock.py:174",
         "launches": cgnet["launches"]["cgblock"],
         "max_abs_err": max(r["max_abs_err"] for r in cg_main),
         "ms": sum(r["launches_per_predict"] * r["ms"] for r in cg_main),
         "plain_ms": sum(r["launches_per_predict"] * r["plain_ms"]
                         for r in cg_main),
         "bound_ms": sum(r["launches_per_predict"] * r["bound_ms"]
                         for r in cg_main),
         "bound_by": by(cg_main), "library_ms": None},
    ]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda, "build_seconds": info.seconds,
         "dsconv": dsconv_rows, "resize_argmax": argmax_rows,
         "resize_ce_sums": ce_rows, "fused_cgblock_pre": cg_rows,
         "predict": result, "train": trained, "cgnet_predict": cgnet,
         "predict_after_train": interleaved, "pool_unpool": pool_rows,
         "enet_predict": enet_predict, "enet_eval": enet_eval,
         "enet_train": enet_train, "fastscnn_config5_train": fastscnn_config5,
         "kernels": kernels, "device": device}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
