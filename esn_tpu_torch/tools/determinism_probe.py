"""Which operations of a train step on one CUDA card do not repeat bit for
bit, and whether two equal steps do.

    python3 -m esn_tpu_torch.tools.determinism_probe [--out FILE]

A diagnostic, run from the repo root; nothing of it stays in the
program. Two parts:

1. ``torch.use_deterministic_algorithms(True, warn_only=True)`` (with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``) over one ``esn_tpu_torch.cli.train``
   step of each of chip_smoke's two resume configurations, f32 with cuDNN
   deterministic and TF32 off as its strict resume check runs them:
   Fast-SCNN-19 with class-weighted CE and adam, and ``--optim ranger
   --use_lovaszsoftmax --remat``; each once with torch's own backward of
   the bilinear resize and the adaptive pool (the K5/K6 route off) and
   once with K5 and K6. Prints the operations torch flags as having no
   deterministic implementation on CUDA.
2. Two steps from equal states, batch and dropout seed, of Fast-SCNN-19 at
   the CLI's crop (b8, 3x512x1024, class-weighted CE through K3, adam):
   whether their losses, gradients, BN statistics and parameters are
   equal bit for bit, in f32 (TF32 off) and bf16, with cuDNN's
   deterministic flag off (the library default) and on, with K5/K6 and
   with torch's backward; and a ``--remat`` step against the step
   without it, bf16, both flags.

Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import re
import subprocess
import sys
import tempfile
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CLI_HW = (512, 1024)


@contextlib.contextmanager
def _route(K, kernels: bool):
    """K5/K6's autograd route as it is (``kernels``) or off: torch's own
    backward of the resize and the pool."""
    real = K.kernel_backward
    if not kernels:
        K.kernel_backward = lambda x: False
    try:
        yield
    finally:
        K.kernel_backward = real


def flagged_ops(torch, K, argv, kernels: bool):
    """The operations torch flags over one ``cli.train`` run of ``argv``."""
    from esn_tpu_torch.cli import train as cli_train
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as seen, \
                _route(K, kernels), tempfile.TemporaryDirectory() as tmp:
            warnings.simplefilter("always")
            with contextlib.redirect_stdout(sys.stderr):
                rc = cli_train.main(argv + ["--savedir", tmp])
    finally:
        torch.use_deterministic_algorithms(False)
    if rc != 0:
        raise RuntimeError(f"cli.train {argv} returned {rc}")
    ops = set()
    for w in seen:
        m = re.match(r"(\S+) does not have a deterministic implementation",
                     str(w.message))
        if m:
            ops.add(m.group(1))
    return sorted(ops)


def _step_state(torch, model, out):
    return {"loss": float(out["loss"]),
            "grads": [p.grad.detach().clone() for p in model.parameters()],
            "stats": [b.clone() for b in model.buffers()],
            "params": [p.detach().clone() for p in model.parameters()]}


def _equal(torch, a, b):
    return {"loss": a["loss"] == b["loss"],
            **{k: all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
               for k in ("grads", "stats", "params")}}


def repeat_steps(torch, F, K, S):
    """Part 2: two equal steps (and remat against plain) under each
    setting; which of their readings are equal bit for bit."""
    from esn_tpu_torch.train.optimizers import build_optimizer
    model0, _, batch, cw = S.train_setup(torch, F, "fastscnn", CLI_HW)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for det in (False, True):
            for kernels in (True, False):
                for remat in ((False, True) if dtype == torch.bfloat16
                              else (False,)):
                    torch.backends.cudnn.deterministic = det
                    torch.backends.cudnn.allow_tf32 = dtype != torch.float32
                    runs = []
                    with _route(K, kernels):
                        for again in (False, remat):
                            model = copy.deepcopy(model0)
                            opt = build_optimizer("adam", model.parameters())
                            step = S.train_step(torch, model, opt, cw, dtype,
                                                remat=again)
                            runs.append(_step_state(torch, model,
                                                    step(batch)))
                    torch.cuda.synchronize()
                    rows.append({"dtype": str(dtype).split(".")[-1],
                                 "cudnn_deterministic": det,
                                 "k5_k6": kernels,
                                 "compared": "remat vs plain" if remat
                                 else "two equal steps",
                                 "equal": _equal(torch, *runs)})
                    print("repeat", json.dumps(rows[-1]))
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    return rows


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="JSON of the readings")
    args = parser.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("determinism_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import torch.nn.functional as F

    import chip_smoke as S
    from esn_tpu_torch.ops import kernels as K

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    common = ["--model", "FastSCNN", "--dataset", "cityscapes",
              "--compute_dtype", "float32", "--batch_size", str(S.BATCH),
              "--max_epochs", "1", "--val_epochs", "1", "--synthetic_len",
              str(S.BATCH), "--num_workers", "2"]
    configs = {"weighted_ce_adam": common,
               "ranger_lovasz_remat": common + [
                   "--optim", "ranger", "--use_lovaszsoftmax", "--remat"]}
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    flagged = {}
    for name, cli_args in configs.items():
        for kernels in (False, True):
            key = f"{name}_{'k5_k6' if kernels else 'torch_backward'}"
            flagged[key] = flagged_ops(torch, K, cli_args, kernels)
            print("flagged", key, json.dumps(flagged[key]))
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    repeats = repeat_steps(torch, F, K, S)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"nvidia_smi": smi, "torch": torch.__version__,
             "flagged": flagged, "repeats": repeats}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
