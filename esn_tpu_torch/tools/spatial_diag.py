"""Diagnoses of spatial sharding on one CUDA card, at the sizes, steps and
gates of ``chip_smoke.py``'s ``spatial`` phase.

    python3 -m esn_tpu_torch.tools.spatial_diag [--out FILE]

- ``windows``: each conv and transposed conv of Fast-SCNN-19 (config 5)
  and ENet-19 (512x1024), in their train-mode forward at batch 8, f32
  (TF32 off) and bf16, over the whole tensor against the same op over the
  two windows of rows that the spatial path computes (zeros beyond the
  image's border): the convs whose outputs differ, and the largest share
  of elements that do. cuDNN may pick another algorithm for a window.
- ``faults``: the phase's first steps (``chip_smoke.sp_first_step``, f32
  with TF32 off and bf16) on (1 data x 2 model) ranks sharing the card
  under gloo, with a fault planted in every rank's row exchange:
  ``zero_halo`` (the fetched rows are zeros, as if each shard's border
  were the image's) and ``shifted_halo`` (each fetched row is the row one
  above it), and ``none``. Each rank's readings (``chip_smoke.sp_readings``
  against one process and the f64 step) stand beside the phase's gate
  (``chip_smoke.SP_GATES``), with the bounds each breaks.

Run from the repo root. Prints one JSON line a reading; ``--out`` also
writes them all as one JSON file. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DTYPES = ("float32", "bfloat16")
FAULTS = ("none", "zero_halo", "shifted_halo")


def conv_windows(torch, F, arch, hw, dtype):
    """The convs of ``arch``'s forward whose outputs over the spatial
    path's windows of rows differ from the whole tensor's (see the module
    docstring), out of how many, and the largest share of elements."""
    import chip_smoke as S
    from esn_tpu_torch.models import build_model
    from esn_tpu_torch.nn import layers, set_dropout_generator
    from esn_tpu_torch.parallel import spatial

    def pair(v):
        return (v, v) if isinstance(v, int) else tuple(v)

    def window(x, lo, hi):
        out = x.new_zeros(x.shape[:2] + (hi - lo, x.shape[3]))
        a, b = max(lo, 0), min(hi, x.shape[2])
        out[:, :, a - lo:b - lo] = x[:, :, a:b]
        return out.contiguous(memory_format=torch.channels_last)
    model = build_model(arch, S.CLASSES, device="cuda",
                        generator=torch.Generator().manual_seed(0)).train()
    set_dropout_generator(model, torch.Generator(device="cuda").manual_seed(1))
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: seen.append((m, i[0].detach())))
        for m in model.modules()
        if isinstance(m, (layers.Conv, layers.ConvTranspose))]
    x = torch.randn((S.BATCH, 3) + tuple(hw), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.no_grad():
        model(x.to(dtype).contiguous(memory_format=torch.channels_last))
        for h in hooks:
            h.remove()
        differ, worst = [], 0.0
        ax = spatial.Axis(S.SP_RANKS, 0, None)
        for i, (m, xin) in enumerate(seen):
            w = m.weight.to(dtype)
            b = None if m.bias is None else m.bias.to(dtype)
            k, (s, sw), (p, pw) = m.weight.shape[2], pair(m.stride), \
                pair(m.padding)
            h = xin.shape[2] // S.SP_RANKS
            if isinstance(m, layers.ConvTranspose):
                op = pair(m.output_padding)
                y = F.conv_transpose2d(xin, w, b, m.stride, m.padding,
                                       m.output_padding)
                wins, ho, _ = spatial.transpose_windows(h, ax, k, s, p, op[0])
                ys = torch.cat([F.conv_transpose2d(
                    window(xin, lo, hi), w, b, (s, sw), (0, pw), (0, op[1])
                ).narrow(2, j * ho + p - lo * s, ho)
                    for j, (lo, hi) in enumerate(wins)], 2)
            else:
                if k == 1 and s == 1 and p == 0:
                    continue
                y = F.conv2d(xin, w, b, m.stride, m.padding, m.dilation,
                             m.groups)
                wins, _ = spatial.stencil_windows(h, ax, k, s, p,
                                                  pair(m.dilation)[0])
                ys = torch.cat([F.conv2d(window(xin, lo, hi), w, b, m.stride,
                                         (0, pw), m.dilation, m.groups)
                                for lo, hi in wins], 2)
            share = float((ys != y).float().mean())
            if share:
                differ.append(f"{i}:{type(m).__name__}{tuple(m.weight.shape)}")
                worst = max(worst, share)
    return {"convs": len(seen), "differ": differ, "largest_share": worst}


def fault_rank_main():
    """One rank of ``faults`` (with no group, the one-process run): for
    each fault of FAULTS planted in the row exchange, the first steps of
    every model of the phase in each dtype of DTYPES."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as S
    from esn_tpu_torch.parallel import mesh, spatial
    if mesh.active():
        spatial.make_spatial_mesh(mesh.world().size // S.SP_RANKS,
                                  S.SP_RANKS)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    real = spatial._exchange
    planted = {
        "none": real,
        "zero_halo": lambda x, plan, ax: torch.zeros_like(real(x, plan, ax)),
        "shifted_halo": lambda x, plan, ax: real(torch.roll(x, 1, 2), plan,
                                                 ax)}
    out = {"rank": mesh.world().rank}
    try:
        for fault in FAULTS if mesh.active() else ("none",):
            spatial._exchange = planted[fault]
            out[fault] = {arch: {d: S.sp_first_step(torch, F, arch, hw,
                                                    getattr(torch, d))
                                 for d in DTYPES}
                          for arch, hw in S.SP_MODELS}
            torch.cuda.empty_cache()
    finally:
        spatial._exchange = real
    return out


def faults(torch, F):
    """Every rank's readings of every fault, model and dtype beside the
    phase's gate: ``{fault: {f"rank{r}_{arch}_{dtype}": row}}``."""
    import chip_smoke as S
    from esn_tpu_torch.parallel import launch
    from esn_tpu_torch.tools import spatial_diag     # by name, for spawn
    skip = {arch: S.zero_gradient_leaves(torch, F, arch)[1]
            for arch, _ in S.SP_MODELS}
    oracle = {arch: S.sp_oracle(torch, F, arch, hw)
              for arch, hw in S.SP_MODELS}
    one = launch.to_numpy(spatial_diag.fault_rank_main())["none"]
    torch.cuda.empty_cache()
    ranks = launch.run_ranks(spatial_diag.fault_rank_main, S.SP_RANKS,
                             device="cuda", timeout=S.DP_LIMIT, threads=None)
    rows = {}
    for fault in FAULTS:
        for r in ranks:
            for arch, _ in S.SP_MODELS:
                for d in DTYPES:
                    got = S.sp_readings(r[fault][arch][d], one[arch][d],
                                        skip[arch], oracle[arch])
                    gate = S.SP_GATES[arch][d]
                    rows.setdefault(fault, {})[
                        f"rank{r['rank']}_{arch}_{d}"] = {
                        **got, "bounds": gate,
                        "broken": sorted(k for k, v in gate.items()
                                         if not got[k] <= v)}
    return rows


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="write the readings "
                        "as one JSON file")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("spatial_diag: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import torch.nn.functional as F

    import chip_smoke as S
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    torch.backends.cudnn.allow_tf32 = False
    windows = {f"{arch}_{d}": conv_windows(torch, F, arch, hw,
                                           getattr(torch, d))
               for arch, hw in S.SP_MODELS for d in DTYPES}
    torch.backends.cudnn.allow_tf32 = True
    for k, v in windows.items():
        print("windows", k, json.dumps(v), flush=True)
    readings = faults(torch, F)
    for fault, rows in readings.items():
        for k, v in rows.items():
            print("fault", fault, k, json.dumps(v), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"windows": windows, "faults": readings}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
