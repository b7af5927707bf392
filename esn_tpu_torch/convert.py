"""Convert the reference's variables tree to the port's ``state_dict`` and
back.

The reference keeps ``{"params": {...}, "stats": {...}}`` as nested dicts
keyed by scope name; the port's submodule attribute names equal those
scope names, so a variable at path ``a/b/leaf`` is the ``state_dict``
entry ``a.b.<name>``. Leaves map as:

========================  =====================  ============================
reference                 port                   layout
========================  =====================  ============================
params ``kernel`` (HWIO)  ``weight`` (OIHW)      transpose (3, 2, 0, 1)
params ``scale``          BN ``weight``          as is
params ``bias``           ``bias``               as is
params ``alpha``          PReLU ``weight``       as is
stats ``mean``/``var``    ``running_mean/var``   as is
========================  =====================  ============================

Leaves are numpy arrays on the reference side and CPU tensors on the
port's; values are copied bit for bit.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_PARAMS = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "alpha": "weight"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for name, node in tree.items():
        if isinstance(node, Mapping):
            yield from _leaves(node, prefix + (name,))
        else:
            yield prefix + (name,), np.asarray(node)


def to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Reference variables -> port ``state_dict`` (CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for coll, names in (("params", _PARAMS), ("stats", _STATS)):
        for path, arr in _leaves(variables.get(coll, {})):
            *mod, leaf = path
            if leaf not in names:
                raise KeyError(f"{coll}/{'/'.join(path)}: no mapping for "
                               f"{leaf!r}")
            if leaf == "kernel":
                if arr.ndim != 4:
                    raise ValueError(f"{'/'.join(path)}: kernel must be "
                                     f"HWIO, got shape {arr.shape}")
                arr = arr.transpose(3, 2, 0, 1)
            key = ".".join([*mod, names[leaf]])
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def to_variables(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """Port ``state_dict`` -> reference variables (numpy leaves).
    ``num_batches_tracked`` entries, if any, are dropped."""
    bn_modules = {k.rsplit(".", 1)[0] for k in state_dict
                  if k.endswith(".running_mean")}
    variables: Dict[str, Dict] = {"params": {}, "stats": {}}
    for key, value in state_dict.items():
        mod, name = key.rsplit(".", 1)
        arr = value.detach().cpu().contiguous().numpy()
        if name == "num_batches_tracked":
            continue
        if name in ("running_mean", "running_var"):
            coll, leaf = "stats", name[len("running_"):]
        elif name == "bias":
            coll, leaf = "params", "bias"
        elif name == "weight" and mod in bn_modules:
            coll, leaf = "params", "scale"
        elif name == "weight" and arr.ndim == 4:
            coll, leaf, arr = "params", "kernel", arr.transpose(2, 3, 1, 0)
        elif name == "weight" and arr.ndim == 1:
            coll, leaf = "params", "alpha"
        else:
            raise KeyError(f"{key}: no mapping for shape {arr.shape}")
        node = variables[coll]
        for part in mod.split("."):
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    return variables
