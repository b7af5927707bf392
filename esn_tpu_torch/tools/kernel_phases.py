"""Where the time of a kernel goes, phase by phase, on one CUDA card.

    python3 -m esn_tpu_torch.tools.kernel_phases

Run from the repo root. For each kernel in ``PHASES`` (K3's forward and
backward in ``csrc/resize_ce.cu``, K1 in ``csrc/resize_argmax.cu``, K2 in
``csrc/dsconv.cu``, K4 in ``csrc/cgblock.cu``) it builds the kernel's
source as it is and, for each phase, a copy with that phase taken out
(each copy its own ``nvcc``, all started together, into
``esn_tpu_torch/build/phases/``), and times each build at the main path's
shapes (K3 at z (8,128,256,19) r=8, K1 bf16 and f32 at y (8,128,256,19)
r=8, K2 bf16 at Fast-SCNN's ltd.ds1, ltd.ds2 and head.ds1, K4 bf16 at
CGNet's stage2 and stage3, K5 and K6 at Fast-SCNN's config-5 train step:
PPM's four upsamples, the fusion's x4 and the x8 full-resolution tail,
PPM's four pools, K7 bf16 and f32 at ENet's config-5 head and FSSNet's
config-3 head) with CUDA events, in turns (all builds, then
all again in reverse order). A phase's cost is read as the full time less
the time without it; phases that overlap do not add up. The copies
compute wrong results and are used for nothing else. K4 is also timed
under other plans than its planner's (``CGBLOCK_PLANS``: strip width, rows
a step, x buffers, rows a unit), which compute the same result. Each edit
must occur exactly once in its source (``edit``), so an edit of a kernel
that moves or repeats a phase makes this script fail rather than time
something else. K5, K6 and K7 are timed through their Python wrappers with
each build loaded in turn as the kernel library, and PPM's forward and
backward at config 5 is read under ``torch.profiler`` (the device time of
each kernel, K5's and K6's among them), as is K7 at each model's head
(``K7_PROFILED``: its device time a call beside its CUDA-event time and
the wrapper's host time a call). Names given on the command line
(``resize_bilinear_bwd adaptive_pool_bwd ppm subpixel_argmax`` ...) run
only those kernels. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "esn_tpu_torch" / "build" / "phases"

# kernel -> (its source, {phase: [(text in the source, its replacement)]})
PHASES = {
    "resize_ce_fwd": ("resize_ce.cu", {
        # no copy; the row shifts stay, so every read stays in the band
        "staging": [("  esn::stage_band(smem, zshift, z, b, h, w, c, i0, j0, wb, zstride, "
                     "esn::aligned16(z), tid);\n", "  if (tid < kBand + 2) zshift[tid] = 0;\n")],
        "pixels": [("      nll_pair(col, fa, fb, va ? ya : 0, vb ? yb : 0, eps, na, nb);",
                    "      na = nb = fa;")],
        "exp": [("      sa[k & 1] += ex2(col.scaled(k, fa));\n"
                 "      sb[k & 1] += ex2(col.scaled(k, fb));",
                 "      sa[k & 1] += col.scaled(k, fa);\n"
                 "      sb[k & 1] += col.scaled(k, fb);")],
        "labels": [("      const int ya = __ldg(lcol + Y * W);\n"
                    "      const int yb = two ? __ldg(lcol + (Y + 1) * W) : ignore;",
                    "      const int ya = (Y + tid) % c;\n"
                    "      const int yb = (Y + 1 + tid) % c;")],
    }),
    "resize_ce_bwd": ("resize_ce.cu", {
        "fold": [("  resize_ce_fold_kernel<<<", "  if (0) resize_ce_fold_kernel<<<")],
        "pixels": [("    if (active && valid_label(y, c, ignore))\n      pixel_grad",
                    "    if (false)\n      pixel_grad")],
        "exp": [("        v[k] = __expf(v[k] - m);\n        s4[k & 3]",
                 "        v[k] = v[k] - m;\n        s4[k & 3]")],
        "labels": [("y_next = __ldg(lcol + (int64_t)(Y + 1) * W);",
                    "y_next = (Y * 7 + tid) % c;")],
        "contraction": [("for (int q = tid; q < npair; q += kThreads) {",
                         "for (int q = tid; q < 0; q += kThreads) {")],
    }),
    "resize_argmax": ("resize_argmax.cu", {
        "staging": [("  esn::stage_band(ys, shift, y, b, h, w, c, i0, j0, wb, stride, "
                     "esn::aligned16(y), tid);\n", "  if (tid < kBand + 2) shift[tid] = 0;\n")],
        "pixels": [("    argmax_pair(col, fa, fb, aa, ab);", "    aa = ab = Y;")],
        # the pixels stay live: a store the compiler cannot rule out (aa +
        # ab < 2 * kRegClasses <= w at the timed shape)
        "stores": [("    ocol[Y * W] = aa;\n    ocol[(Y + (two ? 1 : 0)) * W] = two ? ab : aa;",
                    "    if (aa + ab == w) ocol[0] = aa;")],
    }),
    "dsconv": ("dsconv.cu", {
        "depthwise": [("    depthwise<T>(a, p, cur, smem, tid);\n", "")],
        "product": [("      pointwise_bf16(a, p, smem, cur, tid);\n", "")],
        "prefetch": [("      stage_halo<T>(a, p, bufs + ((it + 1) & 1) * buf_elems, next, vec, tid);\n",
                      "")],
        "stores": [("      if (oh < a.h_out && ow < a.w_out)", "      if (oh < 0)")],
    }),
    "cgblock": ("cgblock.cu", {
        # no read of x from device memory; the buffer is still zero-filled
        "staging": [("      esn::cp_async16(xs + q * p.ldx + v * p.ve, src, in);",
                     "      esn::cp_async16(xs + q * p.ldx + v * p.ve, src, false);")],
        "reduce": [("        reduce_bf16(a, p, u, step, xs, "
                    "reinterpret_cast<const __nv_bfloat16*>(smem + p.o_w1),\n"
                    "                    aff, ys, tid);", "        (void)xs;")],
        # the reduce's two halves: the tensor-core loop, and the affine +
        # PReLU + store of y into the ring
        "product": [("  for (int k0 = 0; k0 < kp; k0 += 16) {\n    unsigned af[4];",
                     "  for (int k0 = 0; k0 < kp - 16 * ldx; k0 += 16) {\n    unsigned af[4];")],
        "epilogue": [("        if (yp[hr].offset < 0) continue;",
                      "        if (yp[hr].offset < 0 || acc[i][0] != 123.25f) continue;")],
        "stencils": [("      if (o1 > o0) stencils<T>(", "      if (o1 > o0 && a.d < 0) stencils<T>(")],
        # the stencils stay live through the channel sums: a store the
        # compiler cannot rule out
        "stores": [("      if (a.jvec) {  // both", "      if (a.jvec && jl[0] != 123.25f) {\n"
                    "      } else if (a.jvec) {  // both")],
    }),
    # K5 and K6, the backward of the bilinear resize and of the adaptive pool
    "resize_bilinear_bwd": ("resize_bilinear_bwd.cu", {
        # streaming: no read of g from device memory (the stages zero-filled)
        "staging": [("cp_async16_upto(dst + 16 * k, src + 16 * k, left < 16 ? (int)left : 16);",
                     "cp_async16_upto(dst + 16 * k, src + 16 * k, 0);")],
        # streaming: the row sums from shared memory (one read kept)
        "rows": [("        for (int t = 0; t < len[m]; ++t)\n"
                  "          r = esn::fma_rn(wj[t], esn::load_acc(src + t * vals), r);",
                  "        r = wj[0] * esn::load_acc(src);")],
        # streaming: the fold of row sums into the two open input rows
        "fold": [("        if (use0) acc0[m] = esn::fma_rn(wh0, r, acc0[m]);\n"
                  "        if (use1) acc1[m] = esn::fma_rn(wh1, r, acc1[m]);",
                  "        acc0[m] += r;")],
        "store": [("      if (it < items) esn::store_acc(gx + out0 + y * out_row + it, acc0[m]);",
                   "      if (it < items && acc0[m] == (A)123.25)\n"
                   "        esn::store_acc(gx + out0 + y * out_row + it, acc0[m]);")],
        # fan-in: the lanes' reads of g (from L2 or device memory)
        "fanin_loads": [("r = esn::fma_rn(ww[t], esn::load_acc(s + t * vals), r);",
                         "r = esn::fma_rn(ww[t], (A)t, r);")],
        # fan-in: lane 0's fold of the row sums, with each row's weight
        "fanin_fold": [("acc = esn::fma_rn(ah.weight(d0 + m0 + k, y), rows[l * pl.lanes + k], acc);",
                        "acc += rows[l * pl.lanes + k];")],
    }),
    "adaptive_pool_bwd": ("adaptive_pool_bwd.cu", {
        # the two divisions of each bin value
        "divisions": [("    v[k] = esn::load_acc(g + at) / (A)bh.size(a0 + a) / (A)bw.size(b0 + b);",
                       "    v[k] = esn::load_acc(g + at);")],
        "loads": [("    v[k] = esn::load_acc(g + at) / (A)bh.size(a0 + a) / (A)bw.size(b0 + b);",
                   "    v[k] = (A)at / (A)bh.size(a0 + a) / (A)bw.size(b0 + b);")],
        # the channels_last 16-byte stores
        "store": [("        store16(gx + out0 + xl * c + ch, acc);",
                   "        if (acc[0] == (A)123.25) store16(gx + out0 + xl * c + ch, acc);")],
    }),
    # K7, the subpixel class argmax (bf16: tensor cores over a staged tile,
    # a phase pair a product; the first design's edits, f32 FMAs and x read
    # by tap, are at git eb9a327)
    "subpixel_argmax": ("subpixel_argmax.cu", {
        # no read of x from device memory; the tiles are still zero-filled
        "staging": [("      cp_async16(dst, in ? xb + (gy * g.w + gx) * g.ci + 8 * k.u : x, in);",
                     "      cp_async16(dst, in ? xb + (gy * g.w + gx) * g.ci + 8 * k.u : x, false);")],
        # every ldmatrix + mma step; the accumulators set to the bias
        "products": [("    step(std::true_type{}, en[0], 0);\n"
                      "#pragma unroll 1\n"
                      "    for (int k0 = 16; k0 < p.kp; k0 += 16)",
                      "#pragma unroll\n"
                      "    for (int i = 0; i < RPW; ++i)\n"
                      "#pragma unroll\n"
                      "      for (int j = 0; j < NTP; ++j)\n"
                      "        acc[i][j][0] = acc[i][j][2] = bc[j][0], "
                      "acc[i][j][1] = acc[i][j][3] = bc[j][1];\n"
                      "    for (int k0 = 16; k0 < 16; k0 += 16)"),
                     ("    for (int e = 1; e < g.npairs[rh]; ++e) {",
                      "    for (int e = 1; e < g.npairs[rh] - kMaxPairs; ++e) {")],
        # the first max: the lane pair's max, then its least class at it
        "argmax": [("      const int cls0 = first_max<NTP>(acc[i], 0, lane), "
                    "cls1 = first_max<NTP>(acc[i], 1, lane);",
                    "      const int cls0 = __float_as_int(acc[i][0][0] + acc[i][NTP - 1][1]) & 31,\n"
                    "                cls1 = __float_as_int(acc[i][0][2] + acc[i][NTP - 1][3]) & 31;")],
        # the map's stores: one the compiler cannot rule out
        "stores": [("      if (q < g.h && px0 + m < g.w)\n",
                    "      if (q < g.h && px0 + m < g.w && cls0 + cls1 == g.w)\n")],
    }),
}

# K4's shapes in CGNet predict at batch 8, and the plans timed beside the
# planner's: (strip width, y rows a step, x buffers, output rows a unit),
# 0 for the planner's choice
CGBLOCK_SHAPES = (("stage2", (8, 256, 512, 64), 2), ("stage3", (8, 128, 256, 128), 4))
CGBLOCK_PLANS = ((0, 0, 0, 0), (0, 8, 1, 0), (0, 4, 2, 0), (0, 4, 1, 0), (0, 2, 2, 0),
                 (0, 2, 1, 0), (0, 1, 2, 0), (16, 4, 2, 0), (0, 0, 0, 16), (0, 0, 0, 64))


def edit(text: str, edits, what: str) -> str:
    """``text`` with each (old, new) of ``edits`` applied; each old must
    occur exactly once in the text it is applied to."""
    for old, new in edits:
        count = text.count(old)
        if count != 1:
            raise RuntimeError(f"{what}: {old!r} occurs {count} times in the source, "
                               f"want once")
        text = text.replace(old, new)
    return text


def build_all(kernels=None):
    """{(kernel, phase or "full"): loaded library} for ``kernels`` (all of
    ``PHASES`` if None); one full build a source."""
    from esn_tpu_torch.ops.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    jobs, texts = {}, {}
    def start(name, text):
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.SRC_DIR), "-shared",
               "-o", str(so), str(cu), str(_build.SRC_DIR / "common.cu")]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    builds = {}
    for kernel, (src, phases) in PHASES.items():
        if kernels is not None and kernel not in kernels:
            continue
        if src not in texts:
            texts[src] = (_build.SRC_DIR / src).read_text()
            start(Path(src).stem, texts[src])
        builds[(kernel, "full")] = Path(src).stem
        for phase, edits in phases.items():
            name = f"{kernel}-{phase}"
            start(name, edit(texts[src], edits, f"{src} {kernel} {phase}"))
            builds[(kernel, phase)] = name
    loaded = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        loaded[name] = ctypes.CDLL(str(so))
    return {key: loaded[name] for key, name in builds.items()}


def in_turns(torch, calls: dict, iters: int = 20) -> dict:
    """ms per call of each entry, timed all in order, then in reverse."""
    def ms(fn):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    times = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            times[name].append(ms(calls[name]))
    return {name: sum(v) / len(v) for name, v in times.items()}


def report(label: str, times: dict) -> None:
    full = times["full"]
    print(f"{label}: full {full:.4f} ms")
    for phase, t in times.items():
        if phase != "full":
            print(f"  without {phase:12s} {t:.4f} ms   (phase ~{full - t:+.4f} ms)")


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from esn_tpu_torch.ops.kernels import _build
    names = set(argv) or set(PHASES) | {"ppm"}
    unknown = names - set(PHASES) - {"ppm"}
    if unknown:
        print(f"kernel_phases: unknown {sorted(unknown)}; known: "
              f"{sorted(PHASES)} and ppm", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    libs = build_all(names)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(0)

    def entry(lib, name):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _build.SIGNATURES[name]
        return fn

    def of(kernel):
        return {phase: lib for (k, phase), lib in libs.items() if k == kernel}

    bwd_phases(torch, libs, names, gen)
    if "subpixel_argmax" in names:
        subpixel_phases(torch, libs, gen)
    if "ppm" in names:
        ppm_profile(torch)
    if not names & {"resize_ce_fwd", "resize_ce_bwd", "resize_argmax",
                    "dsconv", "cgblock"}:
        return 0

    # K3 forward and backward at the train step's shape
    b, h, w, c, r = 8, 128, 256, 19, 8
    z = torch.randn((b, h, w, c), generator=gen, device="cuda")
    lab = torch.randint(0, c, (b, h * r, w * r), generator=gen, device="cuda",
                        dtype=torch.int32)
    cw = torch.rand((c,), generator=gen, device="cuda") + 0.5
    g_s, s, n = (torch.ones((), device="cuda") for _ in range(3))
    dz = torch.empty_like(z)
    calls = {}
    for phase, lib in of("resize_ce_fwd").items():
        part = torch.empty((entry(lib, "esn_resize_ce_fwd_scratch")(b, h, w, c, r),),
                           dtype=torch.float64, device="cuda")
        calls[phase] = (lambda fn=entry(lib, "esn_resize_ce_fwd"), part=part: _check(fn(
            ptr(z), ptr(lab), ptr(cw), ptr(part), ptr(s), ptr(n), b, h, w, c, r, 255,
            ctypes.c_float(0.0), stream())))
    report(f"resize_ce forward {tuple(z.shape)} r={r}", in_turns(torch, calls))
    calls = {}
    for phase, lib in of("resize_ce_bwd").items():
        slabs = torch.empty((entry(lib, "esn_resize_ce_bwd_scratch")(b, h, w, c, r),),
                            device="cuda")
        calls[phase] = (lambda fn=entry(lib, "esn_resize_ce_bwd"), slabs=slabs: _check(fn(
            ptr(z), ptr(lab), ptr(cw), ptr(g_s), ptr(slabs), ptr(dz), b, h, w, c, r, 255,
            ctypes.c_float(0.0), stream())))
    report(f"resize_ce backward {tuple(z.shape)} r={r}", in_turns(torch, calls))

    # K1 at the predict tail's shape, bf16 and f32
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        y = torch.randn((b, h, w, c), generator=gen, device="cuda").to(dtype)
        out = torch.empty((b, h * r, w * r), dtype=torch.int32, device="cuda")
        calls = {phase: (lambda fn=entry(lib, "esn_resize_argmax"): _check(fn(
            ptr(y), ptr(out), code, b, h, w, c, r, stream())))
            for phase, lib in of("resize_argmax").items()}
        report(f"resize_argmax {str(dtype).split('.')[-1]} {tuple(y.shape)} r={r}",
               in_turns(torch, calls))

    # K2 bf16 at Fast-SCNN's layers
    for layer, shape, cout, stride in (("ltd.ds1", (8, 512, 1024, 32), 48, 2),
                                       ("ltd.ds2", (8, 256, 512, 48), 64, 2),
                                       ("head.ds1", (8, 128, 256, 128), 128, 1)):
        nn, hh, ww, cin = shape
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        params = [torch.randn((3, 3, cin), generator=gen, device="cuda") / 3,
                  torch.rand((cin,), generator=gen, device="cuda") + 0.5,
                  torch.randn((cin,), generator=gen, device="cuda") * 0.1,
                  torch.randn((cin, cout), generator=gen, device="cuda") / cin ** 0.5,
                  torch.rand((cout,), generator=gen, device="cuda") + 0.5,
                  torch.randn((cout,), generator=gen, device="cuda") * 0.1]
        ho, wo = (hh - 1) // stride + 1, (ww - 1) // stride + 1
        out = torch.empty((nn, ho, wo, cout), dtype=torch.bfloat16, device="cuda")
        calls = {phase: (lambda fn=entry(lib, "esn_dsconv_forward"): _check(fn(
            ptr(x), *map(ptr, params), ptr(out), 1, nn, hh, ww, cin, cout, ho, wo, stride,
            1, 1, stream())))
            for phase, lib in of("dsconv").items()}
        report(f"dsconv bf16 {layer} {shape} -> {cout} s{stride}", in_turns(torch, calls))

    # K4 bf16 at CGNet's two block shapes: the phases, then the plans
    for layer, shape, d in CGBLOCK_SHAPES:
        nn, hh, ww, c = shape
        half = c // 2
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        params = [torch.randn((c, half), generator=gen, device="cuda") / c ** 0.5,
                  torch.rand((half,), generator=gen, device="cuda") + 0.5,
                  torch.randn((half,), generator=gen, device="cuda") * 0.1,
                  torch.rand((half,), generator=gen, device="cuda") * 0.3 + 0.1,
                  torch.randn((3, 3, half), generator=gen, device="cuda") / 3,
                  torch.randn((3, 3, half), generator=gen, device="cuda") / 3,
                  torch.rand((c,), generator=gen, device="cuda") + 0.5,
                  torch.randn((c,), generator=gen, device="cuda") * 0.1,
                  torch.rand((c,), generator=gen, device="cuda") * 0.3 + 0.1]
        j = torch.empty_like(x)
        sums = torch.empty((nn, c), device="cuda")

        def run(lib, plan=(0, 0, 0, 0)):
            entry(lib, "esn_cgblock_pre_tune")(*plan)
            tiles = entry(lib, "esn_cgblock_pre_tiles")(1, nn, hh, ww, c, d)
            if tiles < 0:
                return None
            partial = torch.empty((nn, tiles, c), device="cuda")
            fn = entry(lib, "esn_cgblock_pre")
            def call():
                entry(lib, "esn_cgblock_pre_tune")(*plan)
                _check(fn(ptr(x), *map(ptr, params), ptr(j), ptr(partial), ptr(sums), 1,
                          nn, hh, ww, c, d, 0, stream()))
            return call

        calls = {phase: run(lib) for phase, lib in of("cgblock").items()}
        report(f"cgblock bf16 {layer} {shape} d={d}", in_turns(torch, calls))
        full = of("cgblock")["full"]
        plans = {plan: run(full, plan) for plan in CGBLOCK_PLANS}
        times = in_turns(torch, {k: v for k, v in plans.items() if v is not None})
        entry(full, "esn_cgblock_pre_tune")(0, 0, 0, 0)
        print(f"cgblock bf16 {layer} plans (tw, rows, nbuf, seg), 0 = the planner's:")
        for plan, fn in plans.items():
            print(f"  {plan}: " + (f"{times[plan]:.4f} ms" if fn else "does not fit"))
    return 0


# K5's and K6's shapes in Fast-SCNN's config-5 train step (batch 8,
# 1024x2048): (label, kind, output-gradient shape, input (H, W), dtype)
BWD_SHAPES = (
    *((f"ppm upsample {b}", "resize", (8, 32, 32, 64), (b, b), "bfloat16")
      for b in (1, 2, 3, 6)),
    ("fusion x4", "resize", (8, 128, 128, 256), (32, 64), "bfloat16"),
    ("tail x8", "resize", (8, 19, 1024, 2048), (128, 256), "float32"),
    *((f"ppm pool {b}", "pool", (8, 128, b, b), (32, 64), "float32")
      for b in (1, 2, 3, 6)))


def through_wrapper(libs, kernel, call) -> dict:
    """{phase: a call of ``call`` (a wrapper's launch) with that build of
    ``kernel`` loaded as the kernel library}."""
    from esn_tpu_torch.ops.kernels import _build
    calls = {}
    for (k, phase), lib in libs.items():
        if k != kernel:
            continue
        for name, (argtypes, restype) in _build.SIGNATURES.items():
            if hasattr(lib, name):
                entry = getattr(lib, name)
                entry.argtypes, entry.restype = argtypes, restype

        def swapped(lib=lib):
            _build._LIB = lib
            call()
        calls[phase] = swapped
    return calls


# K7's shapes: ENet's config-5 head and FSSNet's config-3 head at batch 8
# (label, x (N, H, W, I), classes, kernel, padding, bias); K7_PROFILED adds
# the other heads, read under torch.profiler with the built library
K7_SHAPES = (("enet config-5 head", (8, 512, 1024, 16), 19, 3, 1, False),
             ("fssnet config-3 head", (8, 256, 512, 16), 19, 3, 1, True))
K7_PROFILED = K7_SHAPES + (
    ("erfnet/esnet config-3 head", (8, 256, 512, 16), 19, 2, 0, True),
    ("espnet config-3 head", (8, 256, 512, 19), 19, 2, 0, False),
    ("sqnet config-3 head", (8, 256, 512, 32), 19, 2, 0, True),
    ("linknet config-2 head", (8, 176, 240, 32), 11, 2, 0, True))


def subpixel_phases(torch, libs, gen) -> None:
    """K7 at K7_SHAPES, bf16 and f32, each build of its source loaded in
    turn as the library the wrapper calls; then, with the built library,
    at K7_PROFILED: CUDA events a call, the kernel's device time a call
    under torch.profiler and the wrapper's host time a call (a loop of
    launches runs at the larger of the last two)."""
    import math
    from torch.profiler import ProfilerActivity, profile
    from esn_tpu_torch.ops import kernels as K
    from esn_tpu_torch.ops.kernels import _build

    def args(shape, cout, k, bias, dtype):
        cin = shape[-1]
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w = torch.randn((cin, cout, k, k), generator=gen, device="cuda") / math.sqrt(cin * k)
        b = torch.randn((cout,), generator=gen, device="cuda") * 0.1 if bias else None
        return x, w, b
    for label, shape, cout, k, p, bias in K7_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x, w, b = args(shape, cout, k, bias, dtype)
            calls = through_wrapper(libs, "subpixel_argmax", lambda: K.subpixel_argmax(
                x, w, b, stride=(2, 2), padding=(p, p)))
            report(f"subpixel_argmax {str(dtype).split('.')[-1]} {label} {shape} -> {cout} "
                   f"k{k}", in_turns(torch, calls))
            del x
            torch.cuda.empty_cache()
    _build._LIB = None
    for label, shape, cout, k, p, bias in K7_PROFILED:
        for dtype in (torch.bfloat16, torch.float32):
            x, w, b = args(shape, cout, k, bias, dtype)

            def call():
                K.subpixel_argmax(x, w, b, stride=(2, 2), padding=(p, p))
            events = in_turns(torch, {"full": call})["full"]
            calls = 20
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    call()
                torch.cuda.synchronize()
            device = sum(getattr(ev, "self_device_time_total",
                                 getattr(ev, "self_cuda_time_total", 0))
                         for ev in prof.key_averages()
                         if ev.device_type == torch.autograd.DeviceType.CUDA
                         and "subpixel_argmax" in ev.key) / calls / 1e3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                call()
            host = (time.perf_counter() - t0) / 100 * 1e3
            torch.cuda.synchronize()
            print(f"subpixel_argmax {str(dtype).split('.')[-1]} {label} {shape} -> {cout} k{k}: "
                  f"events {events:.4f} ms, device (profiler) {device:.4f} ms, "
                  f"host a call {host:.4f} ms")
            del x
            torch.cuda.empty_cache()


def bwd_phases(torch, libs, names, gen) -> None:
    """K5 and K6 at BWD_SHAPES (channels_last), each build of their
    sources loaded in turn as the library the wrappers call."""
    from esn_tpu_torch.ops import kernels as K
    from esn_tpu_torch.ops.kernels import _build
    kinds = {"resize": "resize_bilinear_bwd", "pool": "adaptive_pool_bwd"}
    for label, kind, g_shape, in_hw, dtype in BWD_SHAPES:
        kernel = kinds[kind]
        if kernel not in names:
            continue
        g = torch.randn(g_shape, generator=gen, device="cuda").to(
            getattr(torch, dtype)).contiguous(memory_format=torch.channels_last)
        fn = getattr(K, kernel)
        calls = through_wrapper(libs, kernel, lambda: fn(g, in_hw))
        report(f"{kernel} {dtype} {label} g {g_shape} -> {in_hw}",
               in_turns(torch, calls))
        # the wrapper's own time a call on the host: launches queued
        # without a wait, so a loop of launches runs at the larger of
        # this and the kernel's time
        calls["full"]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            calls["full"]()
        host = (time.perf_counter() - t0) / 100 * 1e3
        torch.cuda.synchronize()
        print(f"  host a call          {host:.4f} ms")
    _build._LIB = None


def ppm_profile(torch) -> None:
    """PPM (Fast-SCNN's: 128 channels, bins 1, 2, 3, 6) forward and
    backward at config 5's 1/32 map, (8, 128, 32, 64) bf16 channels_last,
    under ``torch.profiler``: the device time of each kernel a step."""
    from torch.profiler import ProfilerActivity, profile
    from esn_tpu_torch.models.blocks import PyramidPooling
    torch.manual_seed(0)
    ppm = PyramidPooling(128).cuda().train()
    x = torch.randn((8, 128, 32, 64), device="cuda").to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last).requires_grad_()

    def step():
        y = ppm(x)
        y.backward(torch.ones_like(y))
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    steps = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # the kernels' own rows (an op's row repeats its kernels' time)
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        if dev > 0:
            rows.append((dev / steps / 1e3, ev.count // steps, ev.key))
    rows.sort(reverse=True)
    print(f"ppm forward+backward (8,128,32,64) bf16 channels_last: device "
          f"ms a step by kernel ({steps} steps), all kernels "
          f"{sum(r[0] for r in rows):.4f} ms")
    for ms, count, key in rows[:30]:
        print(f"  {ms:9.4f} ms  x{count:<3d} {key[:100]}")


def _check(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
