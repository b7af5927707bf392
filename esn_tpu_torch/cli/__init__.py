"""Command-line entry points of the port, with the flags of the reference's
``train.py``, ``test.py`` and ``predict.py``:

    python -m esn_tpu_torch.cli.train --model FastSCNN --dataset cityscapes
    python -m esn_tpu_torch.cli.test --model FastSCNN --checkpoint ...
    python -m esn_tpu_torch.cli.predict --model FastSCNN --checkpoint ...

They run on the CUDA device, and raise without one, unless given
``--cuda False`` (the CPU, with the kernels' plain versions).
"""
import argparse


def str2bool(value) -> bool:
    """argparse type of a boolean flag: "False", "false", "0", "no" and
    "off" are false, "True", "true", "1", "yes" and "on" true.
    (``type=bool`` reads any non-empty string, "False" too, as true.)"""
    if isinstance(value, bool):
        return value
    text = str(value).strip().lower()
    if text in ("true", "1", "yes", "on"):
        return True
    if text in ("false", "0", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {value!r}")


def parse_hw(text: str):
    """"H,W" or "HxW" -> (H, W)."""
    h, w = (int(v) for v in str(text).replace("x", ",").split(","))
    return h, w

