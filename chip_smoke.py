#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``esn_tpu_torch/csrc``, checks each kernel
against its plain PyTorch version at the shapes Fast-SCNN's predict gives
it (bf16 and f32, plus an odd-size case), then runs Fast-SCNN-19 predict
at batch 8, 3x1024x2048, bf16 through the port's entry points
(``build_model`` + ``make_predict_step``) and checks its output, the
kernels' launch counts and its agreement with the same model run on the
plain versions. Exits non-zero on any failure, and when no CUDA device is
present. The last line of standard output is one JSON object; the line
before it lists the kernels: ``ms``/``plain_ms`` per predict (for
``fused_dsconv`` the sum of its four layers' bf16 times, each timed at
its own shape), and for ``resize_argmax`` ``max_abs_err`` is
the largest gap between the f32 upsampled logits of the classes that the
kernel and the plain version chose. Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
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
#  bf16: the output rounds to bf16 (2^-8 relative) and the plain version
#  also rounds its depthwise result to bf16 before the pointwise sum.
DSCONV_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 2e-2)}
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


class SmokeFailure(RuntimeError):
    pass


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
    n, h, w, cin = shape
    dev = "cuda"
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    dw = torch.randn((3, 3, cin), generator=gen, device=dev) / 3
    pw = torch.randn((cin, cout), generator=gen, device=dev) / math.sqrt(cin)
    a1 = torch.rand((cin,), generator=gen, device=dev) + 0.5
    b1 = torch.randn((cin,), generator=gen, device=dev) * 0.1
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
           "within_tol": excess <= 0,
           "ms": cuda_ms(lambda: K.fused_dsconv(*args, **kw)),
           "plain_ms": cuda_ms(lambda: K.dsconv_ref(*args, **kw))}
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
    ref = K.resize_argmax_ref(y, r)
    torch.cuda.synchronize()
    n, h, w, c = shape
    check(got.shape == (n, h * r, w * r) and got.dtype == torch.int32,
          f"resize_argmax {shape} r={r}: {tuple(got.shape)} {got.dtype}")
    gap, mag = upsampled_gap(torch, F, y, r, got, ref)
    rel = ARGMAX_GAP[str(dtype).split(".")[-1]]
    row = {"shape": list(shape), "r": r, "dtype": str(dtype).split(".")[-1],
           "mismatch_rate": float((got != ref).float().mean()),
           "max_abs_err": float(gap.max()), "gap_rel_tol": rel,
           "within_tol": bool((gap <= rel * mag).all()),
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
        row = resize_argmax_case(K, torch, F, gen, (2, 13, 21, CLASSES), 3,
                                 dtype)
        row["layer"] = "odd"
        argmax_rows.append(row)
    for row in dsconv_rows + argmax_rows:
        print("kernel", json.dumps(row))
    bad = [r for r in dsconv_rows + argmax_rows if not r["within_tol"]]
    check(not bad, f"kernel outside tolerance: {bad}")
    return dsconv_rows, argmax_rows


def smooth_images(torch, F, gen, n, hw):
    """Seeded image-like batch: a random field at 1/32 resolution, upsampled,
    plus a little pixel noise, so images differ in their global means (iid
    noise would give every image the same pooled features)."""
    low = torch.randn((n, 3, hw[0] // 32, hw[1] // 32), generator=gen,
                      device=gen.device)
    x = F.interpolate(low, size=hw, mode="bilinear", align_corners=False)
    return x + 0.1 * torch.randn((n, 3, *hw), generator=gen, device=gen.device)


def seeded_model(torch, F, build_model, BatchNorm, seed: int):
    """Fast-SCNN-19 on the card: port init from a seeded generator, BN
    affines drawn from it too, running stats from one train pass at
    momentum 1 over a seeded batch, with each variance floored at
    VAR_FLOOR (random weights leave near-dead channels whose tiny batch
    variance would scale them by up to 1/sqrt(eps))."""
    gen = torch.Generator().manual_seed(seed)
    model = build_model("fastscnn", CLASSES, device="cuda", generator=gen)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for bn in bns:
            bn.weight.copy_(torch.rand(bn.weight.shape, generator=gen) + 0.5)
            bn.bias.copy_(torch.randn(bn.bias.shape, generator=gen) * 0.1)
            bn.momentum = 1.0
        calib = smooth_images(torch, F, gen, 4, (512, 1024)).cuda()
        model.train()
        model(calib.contiguous(memory_format=torch.channels_last))
        for bn in bns:
            bn.momentum = 0.1
            bn.running_var.clamp_(min=VAR_FLOOR)
    return model.eval()


@contextlib.contextmanager
def plain_versions(K):
    """Route the model's kernel calls to the kernels' plain versions (the
    model looks both up in ``esn_tpu_torch.ops.kernels`` at call time)."""
    saved = K.fused_dsconv, K.resize_argmax
    K.fused_dsconv, K.resize_argmax = K.dsconv_ref, K.resize_argmax_ref
    try:
        yield
    finally:
        K.fused_dsconv, K.resize_argmax = saved


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
    row = {"dtype": name, "batch": images.shape[0],
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


def predict_phase(torch, F, K, build_model, BatchNorm, make_predict_step):
    model = seeded_model(torch, F, build_model, BatchNorm, seed=0)
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
    print("predict launches", json.dumps(launches))
    check(launches == {"dsconv": 4, "resize_argmax": 1},
          f"launch counts per predict {launches}")
    check(tuple(pred.shape) == (BATCH, *IMAGE_HW) and pred.dtype == torch.int32,
          f"predict output {tuple(pred.shape)} {pred.dtype}")
    lo, hi = int(pred.min()), int(pred.max())
    check(0 <= lo and hi < CLASSES, f"predict classes in [{lo}, {hi}]")
    n_classes = int((torch.bincount(pred.flatten().long(),
                                    minlength=CLASSES) > 0).sum())
    print(f"predict output int32 {tuple(pred.shape)}, classes in "
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
    print(f"predict bf16 b{BATCH} {IMAGE_HW[1]}x{IMAGE_HW[0]}: "
          f"{img_s['kernel']:.2f} img/s ({ms['kernel']:.3f} ms/batch) with "
          f"the kernels, {img_s['plain']:.2f} img/s ({ms['plain']:.3f} "
          f"ms/batch) with the plain versions; peak {peak_gb:.2f} GB")
    return {"launches": launches, "classes_seen": n_classes,
            "compared": compared, "img_per_s": img_s["kernel"],
            "plain_img_per_s": img_s["plain"], "ms_per_batch": ms,
            "peak_gb": peak_gb, "batch": BATCH}


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
    result = predict_phase(torch, F, K, build_model, BatchNorm,
                           make_predict_step)

    ds_main = [r for r in dsconv_rows
               if r["dtype"] == "bfloat16" and r["layer"] != "odd"]
    tail = next(r for r in argmax_rows
                if r["dtype"] == "bfloat16" and r["layer"] == "predict tail")
    kernels = [
        {"name": "fused_dsconv", "route": "cuda",
         "source": "esn_tpu_torch/csrc/dsconv.cu",
         "replaces": "esn_tpu/ops/pallas/dsconv.py:198",
         "launches": result["launches"]["dsconv"],
         "max_abs_err": max(r["max_abs_err"] for r in ds_main),
         "ms": sum(r["ms"] for r in ds_main),
         "plain_ms": sum(r["plain_ms"] for r in ds_main)},
        {"name": "resize_argmax", "route": "cuda",
         "source": "esn_tpu_torch/csrc/resize_argmax.cu",
         "replaces": "esn_tpu/ops/pallas/resize_argmax.py:123",
         "launches": result["launches"]["resize_argmax"],
         "max_abs_err": tail["max_abs_err"],
         "ms": tail["ms"], "plain_ms": tail["plain_ms"]},
    ]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda, "build_seconds": info.seconds,
         "dsconv": dsconv_rows, "resize_argmax": argmax_rows,
         "predict": result, "kernels": kernels, "device": device}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
