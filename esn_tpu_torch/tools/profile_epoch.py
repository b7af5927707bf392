"""Where a Trainer epoch's time goes on one CUDA card: input, the step's
host call, the card.

    python3 -m esn_tpu_torch.tools.profile_epoch [--out PATH]

Builds the Trainer as ``python -m esn_tpu_torch.cli.train --model
FastSCNN --dataset cityscapes --batch_size 8`` builds it on the card
(bf16, synthetic 1024x2048 sources, the default 512x1024 crop,
``--synthetic_len 32``: 4 steps an epoch), takes one untimed epoch,
then, host clock throughout:

- one epoch as ``Trainer.train_epoch`` runs it, ms per step, and its
  step timer's parts: the wait for each batch, each step's host call
  (augmentation and the train step's dispatch), and the synchronize that
  closes the epoch; the kernels' launches a step;
- the loader alone, ms a batch, with and without ``device_prefetch``;
- ``torch.profiler`` over one epoch: kernel launches a step
  (``cudaLaunchKernel``) and the host-side entries by self time.

Prints one JSON object and writes it to ``--out`` when given. Exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time


def _loader_ms(torch, trainer, epoch, prefetch):
    from ..data.loader import device_prefetch
    trainer.train_loader.set_epoch(epoch)
    it = iter(trainer.train_loader)
    if prefetch:
        it = device_prefetch(it, trainer.device)
    t0 = time.perf_counter()
    n = sum(1 for _ in it)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_epoch: no CUDA device", file=sys.stderr)
        return 1
    from ..ops import kernels as K
    from ..train.trainer import TrainConfig, Trainer

    out = {"device": torch.cuda.get_device_name(0)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        trainer = Trainer(TrainConfig(
            model="FastSCNN", dataset="cityscapes", input_size=(512, 1024),
            batch_size=8, max_epochs=100, synthetic_len=32,
            data_root=tmp + "/none", savedir=tmp, device="cuda"))
        out["trainer_build_s"] = time.perf_counter() - t0
        out["compute_dtype"] = str(trainer.compute_dtype)
        steps = len(trainer.train_loader)
        t0 = time.perf_counter()
        trainer.train_epoch(0)
        torch.cuda.synchronize()
        out["warmup_epoch_s"] = time.perf_counter() - t0

        timer = trainer.step_timer
        timer.reset()
        K.reset_launches()
        t0 = time.perf_counter()
        trainer.train_epoch(1)
        out["epoch_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / steps
        out["kernel_launches_per_step"] = {k: v / steps
                                           for k, v in K.LAUNCHES.items()}
        out["parts"] = {part: timer.summary(part)
                        for part in ("wait", "step", "sync")}
        timer.reset()
        out["loader_ms_per_batch"] = _loader_ms(torch, trainer, 2, False)
        out["prefetch_loader_ms_per_batch"] = _loader_ms(torch, trainer, 3,
                                                         True)

        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            trainer.train_epoch(4)
            torch.cuda.synchronize()
        events = prof.key_averages()
        launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
        out["cuda_launches_per_step"] = launches / steps
        out["host_self_ms_per_step"] = [
            (e.key, e.self_cpu_time_total / 1e3 / steps, e.count / steps)
            for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:15]]
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(out, indent=1))
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
