"""Device-time profile of a model's train step on one CUDA card.

    python3 -m esn_tpu_torch.tools.profile_train [MODEL] [--loss LOSS]
        [--optim OPTIM] [--hw H,W] [--cudnn-deterministic]

MODEL is a registered model name (default ``fastscnn``). LOSS is
``ce`` (weighted CE: through ``logits_lowres`` and the fused resize-CE
kernel on a resize-tail model, its default; on the full logits on a
conv-tail model and on FPENet, a resize tail without ``logits_lowres``),
``ce_ohem`` (the config-5 loss, weighted CE + OHEM on the model's own
full-resolution logits; the default of a conv-tail model), or ``focal``,
``lovasz`` or ``lovasz_hist`` (on the full logits). OPTIM is one of
train.py's optimizers (default ``adam``). Run from the repo root. Uses
``chip_smoke.py``'s training setup (bf16, batch 8, 3x1024x2048 or the
model's size in ``chip_smoke.MODEL_INPUT``, seeded
smooth images and learnable labels, class weights from their histogram,
poly lr; ``--hw`` sets another input size, e.g. CGNet's config-4
768,1536; ``--cudnn-deterministic`` sets
``torch.backends.cudnn.deterministic``, as chip_smoke's strict resume
check does, to read its cost) and profiles 5 train steps with the
kernel, then 5 with the plain versions (skipped where the step launches no kernel: the two
would be the same), each after one untraced warm-up step. For each it
prints the host-clock ms per step with the profiler on and, from 5 more
steps, with it off (synchronised), the summed device time of the CUDA
kernels per step, the device idle share, and the kernels by device time.
The step runs on one stream, so its kernels do not overlap: the idle
share is ``1 - device time / wall time``, against the wall time with the
profiler off (the profiler's own host cost lengthens the traced wall).
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

from .profile_predict import STEPS, TOP, _device_us, profile

REPO = Path(__file__).resolve().parents[2]


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("model", nargs="?", default="fastscnn")
    parser.add_argument("--loss", default=None, choices=[
        "ce", "ce_ohem", "focal", "lovasz", "lovasz_hist"])
    parser.add_argument("--optim", default="adam", choices=[
        "sgd", "adam", "adamw", "radam", "ranger"])
    parser.add_argument("--hw", default=None, help="H,W input size")
    parser.add_argument("--cudnn-deterministic", action="store_true")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import torch.nn.functional as F

    import chip_smoke as S
    from esn_tpu_torch.ops import kernels as K
    from esn_tpu_torch.train.optimizers import build_optimizer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    torch.backends.cudnn.deterministic = args.cudnn_deterministic
    print("cudnn.deterministic", args.cudnn_deterministic)
    classes, hw = S.MODEL_INPUT.get(args.model, (S.CLASSES, S.IMAGE_HW))
    if args.hw:
        hw = tuple(int(v) for v in args.hw.split(","))
    print("input", S.BATCH, "x 3 x", hw, "classes", classes)
    model, _, batch, cw = S.train_setup(torch, F, args.model, hw, classes)
    opt = build_optimizer(args.optim, model.parameters())
    loss = args.loss or ("ce" if model.LOGITS_TAIL == "resize" else "ce_ohem")
    print("model", args.model, "loss", loss, "optim", args.optim)
    if loss == "ce_ohem":
        step = S.config5_step(torch, model, opt, cw, torch.bfloat16)
    else:
        step = S.train_step(torch, model, opt, cw, torch.bfloat16, loss=loss)
    K.reset_launches()
    for label in ("kernel", "plain"):
        ctx = (S.plain_versions(K) if label == "plain"
               else contextlib.nullcontext())
        with ctx:
            wall_ms, device_ms, kernels = profile(torch, step, batch)
            quiet_wall_ms = 1e3 * S.timed_steps(torch, step, batch, STEPS)
        if device_ms <= 0:
            print(f"profile_train: no device time traced ({label})",
                  file=sys.stderr)
            return 1
        print(f"== {label}: wall {quiet_wall_ms:.3f} ms/step (profiler "
              f"on: {wall_ms:.3f}), device kernel time {device_ms:.3f} "
              f"ms/step, idle share {1 - device_ms / quiet_wall_ms:.3f}")
        for e in kernels[:TOP]:
            print(f"{_device_us(e) / STEPS / 1e3:9.3f} ms "
                  f"{e.count // STEPS:4d}x  {e.key[:110]}")
        if not any(K.LAUNCHES.values()):
            print("no kernel on this step's path: no plain pass")
            break
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
