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
CGNet's stage2 and stage3) with CUDA events, in turns (all builds, then
all again in reverse order). A phase's cost is read as the full time less
the time without it; phases that overlap do not add up. The copies
compute wrong results and are used for nothing else. K4 is also timed
under other plans than its planner's (``CGBLOCK_PLANS``: strip width, rows
a step, x buffers, rows a unit), which compute the same result. Each edit
must occur exactly once in its source (``edit``), so an edit of a kernel
that moves or repeats a phase makes this script fail rather than time
something else. Exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
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


def build_all():
    """{(kernel, phase or "full"): loaded library}; one full build a source."""
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from esn_tpu_torch.ops.kernels import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    libs = build_all()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(0)

    def entry(lib, name):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _build.SIGNATURES[name]
        return fn

    def of(kernel):
        return {phase: lib for (k, phase), lib in libs.items() if k == kernel}

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


def _check(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")


if __name__ == "__main__":
    sys.exit(main())
