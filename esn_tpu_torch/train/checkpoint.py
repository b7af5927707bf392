"""Checkpoint and resume (counterpart of ``esn_tpu/train/checkpoint.py``).

A checkpoint is ``{savedir}/model_{epoch}.ckpt``, the reference's naming
(``test --best`` sweeps them): ``torch.save`` of ``{"state": {"model":
state_dict, "optimizer": state_dict, "step": int}, "meta": {"epoch",
"mIoU", "loss", ...}}``, written to a ``.tmp`` file and renamed, so a
crash never leaves a torn file. A resume restores the model's parameters
and BN statistics, the optimizer's moments and the step, so it continues
exactly as an unbroken run would.

The JAX package's checkpoints (flax msgpack of its ``TrainState`` and
meta) load too: :func:`load_checkpoint` and :func:`load_variables` tell
the two formats apart by their first bytes (``torch.save`` writes a zip
archive) and read msgpack with the port's own decoder
(``utils/msgpack_decode.py``: the card's machine has no ``msgpack`` and
no ``flax``). Params and BN stats go through ``convert.to_state_dict``
with the port's model; the optimizer's state (adam's, adamw's and radam's
moments and count, ranger's with its slow weights, or SGD's momentum)
goes into the port's optimizer (``convert.load_optimizer_state``).

:func:`load_encoder` is ESPNet's two-stage recipe: a trained ESPNet-C's
checkpoint, of either package, grafted into ESPNet's ``enc``.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import convert
from ..utils import msgpack_decode
from .state import TrainState

_CKPT_RE = re.compile(r"model_(\d+)\.ckpt$")
_ZIP_MAGIC = b"PK\x03\x04"


def save_checkpoint(savedir: str, epoch: int, state: TrainState,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(savedir, exist_ok=True)
    payload = {"state": state.state_dict(),
               "meta": {"epoch": int(epoch), **(extra or {})}}
    path = os.path.join(savedir, f"model_{epoch}.ckpt")
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _read(path: str) -> Tuple[bool, Any]:
    """``(is_jax, payload)`` of a checkpoint of either package."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == _ZIP_MAGIC:
        return False, torch.load(path, map_location="cpu", weights_only=True)
    return True, msgpack_decode.restore(data)


def _numpy_leaves(tree: Any) -> Any:
    """A decoded tree with every leaf a numpy array (bf16 tensors widened
    to f32, exactly)."""
    if isinstance(tree, Mapping):
        return {k: _numpy_leaves(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return np.asarray(tree)


def _load_jax_variables(model: torch.nn.Module, sd: Mapping) -> None:
    variables = {"params": _numpy_leaves(sd["params"]),
                 "stats": _numpy_leaves(sd["stats"])}
    model.load_state_dict(convert.to_state_dict(variables, model),
                          strict=True)


def load_checkpoint(path: str, state: TrainState
                    ) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore ``state`` in place from a checkpoint of either package;
    returns it and the checkpoint's meta."""
    is_jax, payload = _read(path)
    sd = payload["state"]
    if is_jax:
        _load_jax_variables(state.model, sd)
        convert.load_optimizer_state(state.optimizer, state.model,
                                     _numpy_leaves(sd["opt_state"]))
        state.step = int(sd["step"])
    else:
        state.load_state_dict(sd)
    return state, dict(payload.get("meta", {}))


def load_variables(path: str, model: torch.nn.Module
                   ) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """Restore only the model (parameters and BN statistics) from a full
    checkpoint of either package, for the inference CLIs, whatever
    optimizer trained it."""
    is_jax, payload = _read(path)
    if is_jax:
        _load_jax_variables(model, payload["state"])
    else:
        model.load_state_dict(payload["state"]["model"], strict=True)
    return model, dict(payload.get("meta", {}))


def load_encoder(path: str, model: torch.nn.Module, subtree: str = "enc"
                 ) -> Dict[str, Any]:
    """Graft a trained sub-model's checkpoint (either package's) into
    ``model``'s submodule ``subtree``: its parameters and BN statistics.

    The donor's state must hold every leaf of the submodule, at its
    shape; extra donor leaves (ESPNet-C's classifier ``head``) are
    ignored. A missing leaf raises ``KeyError``, a shape mismatch
    ``ValueError``, both naming the leaf. Returns the donor's meta.
    """
    target = model.get_submodule(subtree)
    is_jax, payload = _read(path)
    sd = payload["state"]
    if is_jax:
        donor = convert.to_state_dict({"params": _numpy_leaves(sd["params"]),
                                       "stats": _numpy_leaves(sd["stats"])},
                                      target)
    else:
        donor = sd["model"]
    graft = {}
    for key, leaf in target.state_dict().items():
        if key not in donor:
            raise KeyError(f"encoder checkpoint {path} has no {key} (for "
                           f"{subtree}.{key})")
        if tuple(donor[key].shape) != tuple(leaf.shape):
            raise ValueError(f"{subtree}.{key}: donor shape "
                             f"{tuple(donor[key].shape)} != target shape "
                             f"{tuple(leaf.shape)}")
        graft[key] = donor[key].to(leaf.dtype)
    target.load_state_dict(graft, strict=True)
    return dict(payload.get("meta", {}))


def latest_checkpoint(savedir: str) -> Optional[str]:
    found = list_checkpoints(savedir)
    return found[-1][1] if found else None


def list_checkpoints(savedir: str):
    """All (epoch, path) pairs, sorted by epoch (``test --best``)."""
    out = []
    if os.path.isdir(savedir):
        for name in os.listdir(savedir):
            m = _CKPT_RE.search(name)
            if m:
                out.append((int(m.group(1)), os.path.join(savedir, name)))
    return sorted(out)


def save_params_only(path: str, model: torch.nn.Module) -> None:
    """Inference-only export: the model's state dict."""
    torch.save(model.state_dict(), path)


def load_params_only(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a params-only export of either package (the reference's is
    the msgpack of ``{"params", "stats"}``) into ``model``."""
    is_jax, payload = _read(path)
    if is_jax:
        _load_jax_variables(model, payload)
    else:
        model.load_state_dict(payload, strict=True)
    return model
