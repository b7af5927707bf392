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

``--uneven`` reads the same at the ``spatial_uneven`` phase's models and
size (``chip_smoke.SPU_MODELS``: Fast-SCNN-19 and LEDNet-19 at CamVid's
720x960, whose stages split into unequal shards) and gate
(``chip_smoke.SPU_GATES``; a model without one is read only), with a
third fault: ``t_miscount`` (BatchNorm counts ``h x S`` rows, as if every
shard held ``T / S`` rows).

Run from the repo root. Prints one JSON line a reading; ``--out`` also
writes them all as one JSON file. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DTYPES = ("float32", "bfloat16")
FAULTS = ("none", "zero_halo", "shifted_halo")
UNEVEN_FAULTS = FAULTS + ("t_miscount",)


def conv_windows(torch, F, arch, hw, dtype, ranks=None):
    """The convs of ``arch``'s forward whose outputs over the spatial
    path's windows of rows (``ranks`` shards, ``chip_smoke.SP_RANKS``
    when None) differ from the whole tensor's (see the module docstring),
    out of how many, and the largest share of elements."""
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
    ranks = ranks or S.SP_RANKS
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
        axes = [spatial.Axis(ranks, j, None) for j in range(ranks)]
        for i, (m, xin) in enumerate(seen):
            w = m.weight.to(dtype)
            b = None if m.bias is None else m.bias.to(dtype)
            k, (s, sw), (p, pw) = m.weight.shape[2], pair(m.stride), \
                pair(m.padding)
            total = xin.shape[2]
            if isinstance(m, layers.ConvTranspose):
                op = pair(m.output_padding)
                y = F.conv_transpose2d(xin, w, b, m.stride, m.padding,
                                       m.output_padding)
                sts = [spatial.transpose_stencil(total, ax, k, s, p, op[0])
                       for ax in axes]
                ys = torch.cat([F.conv_transpose2d(
                    window(xin, *st.windows[j]), w, b, (s, sw), (0, pw),
                    (0, op[1])).narrow(2, st.start, st.rows)
                    for j, st in enumerate(sts)], 2)
            else:
                if k == 1 and s == 1 and p == 0:
                    continue
                y = F.conv2d(xin, w, b, m.stride, m.padding, m.dilation,
                             m.groups)
                sts = [spatial.stencil(total, ax, k, s, p,
                                       pair(m.dilation)[0]) for ax in axes]
                ys = torch.cat([F.conv2d(
                    window(xin, *st.windows[j]), w, b, m.stride, (0, pw),
                    m.dilation, m.groups).narrow(2, 0, st.rows)
                    for j, st in enumerate(sts)], 2)
            share = float((ys != y).float().mean())
            if share:
                differ.append(f"{i}:{type(m).__name__}{tuple(m.weight.shape)}")
                worst = max(worst, share)
    return {"convs": len(seen), "differ": differ, "largest_share": worst}


class _Miscount:
    """``parallel.spatial`` as BatchNorm sees it under ``t_miscount``: its
    ``global_rows`` answers ``h x S`` without a sum."""

    def __init__(self, spatial):
        self._spatial = spatial

    def __getattr__(self, name):
        return getattr(self._spatial, name)

    @staticmethod
    def global_rows(ax, *local):
        return tuple(h * ax.size for h in local)


@contextlib.contextmanager
def planted(fault):
    """``fault`` planted in this process while inside: ``none``,
    ``zero_halo`` (every row exchange gives zeros, as if each shard's
    border were the image's), ``shifted_halo`` (each row an exchange
    sends is the row above it) or ``t_miscount`` (BatchNorm counts ``h x
    S`` rows, as if every shard held ``T / S`` rows)."""
    import torch

    from esn_tpu_torch.nn import layers
    from esn_tpu_torch.parallel import spatial
    real = spatial._exchange
    exchange = {
        "zero_halo": lambda x, plan, ax: torch.zeros_like(real(x, plan, ax)),
        "shifted_halo": lambda x, plan, ax: real(torch.roll(x, 1, 2), plan,
                                                 ax)}.get(fault, real)
    if fault not in UNEVEN_FAULTS:
        raise ValueError(f"fault {fault!r}: one of {UNEVEN_FAULTS}")
    spatial._exchange = exchange
    if fault == "t_miscount":
        layers.spatial = _Miscount(spatial)
    try:
        yield
    finally:
        spatial._exchange = real
        layers.spatial = spatial


def _models(uneven):
    import chip_smoke as S
    return (S.SPU_MODELS, S.SPU_GATES, UNEVEN_FAULTS) if uneven \
        else (S.SP_MODELS, S.SP_GATES, FAULTS)


def fault_rank_main(uneven=False):
    """One rank of ``faults`` (with no group, the one-process run): for
    each fault planted in every rank (the row exchange, or BatchNorm's
    count), the first steps of every model of the phase in each dtype of
    DTYPES."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as S
    from esn_tpu_torch.parallel import mesh, spatial
    if mesh.active():
        spatial.make_spatial_mesh(mesh.world().size // S.SP_RANKS,
                                  S.SP_RANKS)
    models, _, faults = _models(uneven)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": mesh.world().rank}
    for fault in faults if mesh.active() else ("none",):
        with planted(fault):
            out[fault] = {arch: {d: S.sp_first_step(torch, F, arch, hw,
                                                    getattr(torch, d))
                                 for d in DTYPES}
                          for arch, hw in models}
        torch.cuda.empty_cache()
    return out


def faults(torch, F, uneven=False):
    """Every rank's readings of every fault, model and dtype beside the
    phase's gate: ``{fault: {f"rank{r}_{arch}_{dtype}": row}}``."""
    import chip_smoke as S
    from esn_tpu_torch.parallel import launch
    from esn_tpu_torch.tools import spatial_diag     # by name, for spawn
    models, gates, planted = _models(uneven)
    skip = {arch: S.zero_gradient_leaves(torch, F, arch)[1]
            for arch, _ in models}
    oracle = {arch: S.sp_oracle(torch, F, arch, hw) for arch, hw in models}
    one = launch.to_numpy(spatial_diag.fault_rank_main(uneven))["none"]
    torch.cuda.empty_cache()
    ranks = launch.run_ranks(spatial_diag.fault_rank_main, S.SP_RANKS,
                             uneven, device="cuda", timeout=S.DP_LIMIT,
                             threads=None)
    rows = {}
    for fault in planted:
        for r in ranks:
            for arch, _ in models:
                for d in DTYPES:
                    got = S.sp_readings(r[fault][arch][d], one[arch][d],
                                        skip[arch], oracle[arch])
                    gate = None if gates[arch] is None else gates[arch][d]
                    rows.setdefault(fault, {})[
                        f"rank{r['rank']}_{arch}_{d}"] = {
                        **got, "bounds": gate,
                        "broken": sorted(k for k, v in (gate or {}).items()
                                         if not got[k] <= v)}
    return rows


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="write the readings "
                        "as one JSON file")
    parser.add_argument("--uneven", action="store_true",
                        help="the spatial_uneven phase's models, size and "
                             "gate, and the t_miscount fault")
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
    models = _models(args.uneven)[0]
    windows = {f"{arch}_{d}": conv_windows(torch, F, arch, hw,
                                           getattr(torch, d))
               for arch, hw in models for d in DTYPES}
    torch.backends.cudnn.allow_tf32 = True
    for k, v in windows.items():
        print("windows", k, json.dumps(v), flush=True)
    readings = faults(torch, F, args.uneven)
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
