"""Device-time profile of a model's predict on one CUDA card.

    python3 -m esn_tpu_torch.tools.profile_predict [MODEL]

MODEL is a registered model name (default ``fastscnn``; ``cgnet``,
``enet``). Run from the repo root. Uses ``chip_smoke.py``'s seeded model
and images (bf16, batch 8, 3x1024x2048) and profiles 5 predicts with the
kernels, then 5 with their plain versions (skipped where predict
launches no kernel: the two would be the same), each after one untraced
warm-up predict. For each it prints the host-clock ms per batch (synchronised,
profiler on), the summed device time of the CUDA kernels per batch, the
device idle share, and the kernels by device time. Predict runs on one
stream, so its kernels do not overlap: the idle share is
``1 - device time / wall time``. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
STEPS = 5
TOP = 25


def _device_us(event) -> float:
    return getattr(event, "device_time_total",
                   getattr(event, "cuda_time_total", 0.0))


def profile(torch, predict, images):
    """(wall ms per batch, device ms per batch, kernels by device time)."""
    from torch.profiler import ProfilerActivity
    predict(images)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            predict(images)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    kernels = [e for e in prof.key_averages()
               if _device_us(e) > 0 and str(e.device_type).endswith("CUDA")]
    kernels.sort(key=lambda e: -_device_us(e))
    device_ms = sum(_device_us(e) for e in kernels) / STEPS / 1e3
    return wall_ms, device_ms, kernels


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("model", nargs="?", default="fastscnn")
    arch = parser.parse_args(argv).model
    import torch
    if not torch.cuda.is_available():
        print("profile_predict: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import torch.nn.functional as F

    import chip_smoke as S
    from esn_tpu_torch.models import build_model
    from esn_tpu_torch.nn import BatchNorm
    from esn_tpu_torch.ops import kernels as K
    from esn_tpu_torch.train.step import make_predict_step

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    print("model", arch)
    model = S.seeded_model(torch, F, build_model, BatchNorm, seed=0,
                           arch=arch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = S.smooth_images(torch, F, gen, S.BATCH, S.IMAGE_HW)
    predict = make_predict_step(model, compute_dtype=torch.bfloat16)
    K.reset_launches()
    for label in ("kernels", "plain"):
        ctx = (S.plain_versions(K) if label == "plain"
               else contextlib.nullcontext())
        with ctx:
            wall_ms, device_ms, kernels = profile(torch, predict, images)
        if device_ms <= 0:
            print(f"profile_predict: no device time traced ({label})",
                  file=sys.stderr)
            return 1
        print(f"== {label}: wall {wall_ms:.3f} ms/batch, device kernel time "
              f"{device_ms:.3f} ms/batch, idle share "
              f"{1 - device_ms / wall_ms:.3f}")
        for e in kernels[:TOP]:
            print(f"{_device_us(e) / STEPS / 1e3:9.3f} ms "
                  f"{e.count // STEPS:4d}x  {e.key[:110]}")
        if not any(K.LAUNCHES.values()):
            print("no kernel on this model's path: no plain pass")
            break
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
