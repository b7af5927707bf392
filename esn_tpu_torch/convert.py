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
params ``kernel`` (I, O)  Dense ``weight`` (O, I)  transpose (1, 0)
params ``kernel`` (HWIO)  ConvTranspose ``weight``  transpose (2, 3, 0, 1),
of a transposed conv      (I, O, kh, kw)         both spatial axes flipped
params ``scale``          BN ``weight``          as is
params ``bias``           ``bias``               as is
params ``alpha``          PReLU ``weight``       as is
stats ``mean``/``var``    ``running_mean/var``   as is
========================  =====================  ============================

Leaves are numpy arrays on the reference side and CPU tensors on the
port's; values are copied bit for bit.

A transposed conv's kernel cannot be told from a conv's by its shape, so
every function here takes the port's ``model`` and reads from it which
modules are ``ConvTranspose`` (the reference applies such a kernel as a
stride-1 conv over the zero-inserted input, torch as the gradient of a
conv: the spatial flip lies between the two). Without a model every
rank-4 kernel is a conv's, which is right for a model without
transposed convs.

Training state crosses too: any params-shaped tree (gradients, Adam
moments) maps by the same rules (:func:`params_state_dict`,
:func:`params_tree`), and an optax ``adam`` state (``ScaleByAdamState``
``count``/``mu``/``nu``, inside the reference's
``add_decayed_weights``/``scale_by_adam``/``scale_by_learning_rate``
chain, live or as a restored checkpoint's dicts) loads into a
``torch.optim.Adam`` (:func:`load_adam_state`) and comes back out
(:func:`adam_state`); a ``radam`` state is the same ``ScaleByAdamState``
and loads the same way into the port's ``RAdam``; a ``ranger`` state,
``LookaheadState(inner, slow_params, count)``, loads into the port's
``Ranger`` (:func:`load_ranger_state`); an optax ``trace`` (SGD momentum)
loads into a ``torch.optim.SGD`` (:func:`load_sgd_state`).
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Iterator, Mapping, NamedTuple,
                    Optional, Set, Tuple)

import numpy as np
import torch

from .nn.layers import ConvTranspose
from .train.optimizers import Ranger

_PARAMS = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "alpha": "weight"}
_STATS = {"mean": "running_mean", "var": "running_var"}
# kernel rank -> the transpose into the port's layout and back out of it
# (rank 4: a conv, HWIO <-> OIHW; rank 2: a Dense, (I, O) <-> (O, I))
_KERNEL_TO_TORCH = {4: (3, 2, 0, 1), 2: (1, 0)}
_KERNEL_FROM_TORCH = {4: (2, 3, 1, 0), 2: (1, 0)}


def _transposed_modules(model: Optional[torch.nn.Module]) -> Set[str]:
    """Names of ``model``'s transposed convs (none without a model)."""
    if model is None:
        return set()
    return {name for name, m in model.named_modules()
            if isinstance(m, ConvTranspose)}


def _kernel_to_torch(arr: np.ndarray, transposed: bool) -> np.ndarray:
    if transposed:      # (kh, kw, in, out) -> (in, out, kh, kw), flipped
        return arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    return arr.transpose(*_KERNEL_TO_TORCH[arr.ndim])


def _kernel_from_torch(arr: np.ndarray, transposed: bool) -> np.ndarray:
    if transposed:      # (in, out, kh, kw) -> (kh, kw, in, out), flipped
        return arr[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    return arr.transpose(*_KERNEL_FROM_TORCH[arr.ndim])


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for name, node in tree.items():
        if isinstance(node, Mapping):
            yield from _leaves(node, prefix + (name,))
        else:
            yield prefix + (name,), np.asarray(node)


def to_state_dict(variables: Mapping,
                  model: Optional[torch.nn.Module] = None
                  ) -> Dict[str, torch.Tensor]:
    """Reference variables -> port ``state_dict`` (CPU tensors); ``model``
    (the port's) says which kernels are transposed convs'."""
    out: Dict[str, torch.Tensor] = {}
    transposed = _transposed_modules(model)
    for coll, names in (("params", _PARAMS), ("stats", _STATS)):
        for path, arr in _leaves(variables.get(coll, {})):
            *mod, leaf = path
            if leaf not in names:
                raise KeyError(f"{coll}/{'/'.join(path)}: no mapping for "
                               f"{leaf!r}")
            if leaf == "kernel":
                if arr.ndim not in _KERNEL_TO_TORCH:
                    raise ValueError(f"{'/'.join(path)}: kernel must be "
                                     f"HWIO or (in, out), got shape "
                                     f"{arr.shape}")
                arr = _kernel_to_torch(arr, ".".join(mod) in transposed)
            key = ".".join([*mod, names[leaf]])
            out[key] = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return out


def to_variables(state_dict: Mapping[str, torch.Tensor],
                 model: Optional[torch.nn.Module] = None
                 ) -> Dict[str, Dict]:
    """Port ``state_dict`` -> reference variables (numpy leaves); ``model``
    says which weights are transposed convs'. ``num_batches_tracked``
    entries, if any, are dropped."""
    bn_modules = {k.rpartition(".")[0] for k in state_dict
                  if k.rpartition(".")[2] == "running_mean"}
    return _to_variables(state_dict, bn_modules, _transposed_modules(model))


def _to_variables(state_dict: Mapping[str, torch.Tensor],
                  bn_modules: Set[str], transposed: Set[str]
                  ) -> Dict[str, Dict]:
    variables: Dict[str, Dict] = {"params": {}, "stats": {}}
    for key, value in state_dict.items():
        mod, _, name = key.rpartition(".")
        arr = value.detach().cpu().contiguous().numpy()
        if name == "num_batches_tracked":
            continue
        if name in ("running_mean", "running_var"):
            coll, leaf = "stats", name[len("running_"):]
        elif name == "bias":
            coll, leaf = "params", "bias"
        elif name == "weight" and mod in bn_modules:
            coll, leaf = "params", "scale"
        elif name == "weight" and arr.ndim in _KERNEL_FROM_TORCH:
            coll, leaf = "params", "kernel"
            arr = _kernel_from_torch(arr, mod in transposed)
        elif name == "weight" and arr.ndim == 1:
            coll, leaf = "params", "alpha"
        else:
            raise KeyError(f"{key}: no mapping for shape {arr.shape}")
        node = variables[coll]
        for part in filter(None, mod.split(".")):
            node = node.setdefault(part, {})
        node[leaf] = np.array(arr, copy=True, order="C")
    return variables


def params_state_dict(tree: Mapping,
                      model: Optional[torch.nn.Module] = None
                      ) -> Dict[str, torch.Tensor]:
    """A params-shaped reference tree (gradients, Adam moments) -> CPU
    tensors keyed by the port's parameter names, in the port's layout."""
    return to_state_dict({"params": tree}, model)


def params_tree(named: Mapping[str, torch.Tensor],
                model: torch.nn.Module) -> Dict[str, Any]:
    """Tensors keyed by ``model``'s parameter names -> a params-shaped
    reference tree (numpy leaves, reference layout)."""
    bn_modules = {name for name, m in model.named_modules()
                  if hasattr(m, "running_mean")}
    return _to_variables(named, bn_modules,
                         _transposed_modules(model))["params"]


_ADAM_FIELDS = ("count", "mu", "nu")
_LOOKAHEAD_FIELDS = ("inner", "slow_params", "count")


def _find_fields(opt_state: Any, fields: Tuple[str, ...]
                 ) -> Optional[Tuple[Any, ...]]:
    """The ``fields`` of the first state in an optax chain state that has
    them all: the live state (NamedTuples in a tuple) or a restored
    checkpoint's (flax writes a tuple as a dict keyed ``'0'``, ``'1'``,
    ... and a NamedTuple as a dict keyed by its field names)."""
    if isinstance(opt_state, Mapping):
        if all(k in opt_state for k in fields):
            return tuple(opt_state[k] for k in fields)
        subs = opt_state.values()
    elif all(hasattr(opt_state, a) for a in fields):
        return tuple(getattr(opt_state, a) for a in fields)
    elif isinstance(opt_state, (tuple, list)):
        subs = opt_state
    else:
        return None
    for sub in subs:
        found = _find_fields(sub, fields)
        if found is not None:
            return found
    return None


class AdamMoments(NamedTuple):
    count: Any
    mu: Any
    nu: Any


def _find_adam(opt_state: Any) -> Optional[AdamMoments]:
    """``(count, mu, nu)`` of the ``ScaleByAdamState`` in a chain state."""
    found = _find_fields(opt_state, _ADAM_FIELDS)
    return None if found is None else AdamMoments(*found)


def _load_per_parameter(optimizer: torch.optim.Optimizer,
                        model: torch.nn.Module,
                        state_of: Callable[[str], Dict[str, Any]]) -> None:
    """Set ``optimizer``'s state of each of ``model``'s parameters to
    ``state_of(name)``; the optimizer must hold ``model.parameters()`` in
    their order, in one param group."""
    sd = optimizer.state_dict()
    names = [name for name, _ in model.named_parameters()]
    if sorted(sd["param_groups"][0]["params"]) != list(range(len(names))):
        raise ValueError("optimizer must hold model.parameters() in order, "
                         "in one param group")
    sd["state"] = {i: state_of(name) for i, name in enumerate(names)}
    optimizer.load_state_dict(sd)


def load_adam_state(optimizer: torch.optim.Optimizer,
                    model: torch.nn.Module, opt_state: Any) -> None:
    """Load the optax adam state in ``opt_state`` (its ``count``, ``mu``,
    ``nu``) into ``optimizer``, a ``torch.optim.Adam`` (``AdamW``, or the
    port's ``RAdam``: optax's radam state is the same) over
    ``model.parameters()`` in their order: per parameter ``step`` =
    count, ``exp_avg`` = mu, ``exp_avg_sq`` = nu."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no adam state (count/mu/nu) in the optimizer state")
    count, mu, nu = adam
    mu = params_state_dict(mu, model)
    nu = params_state_dict(nu, model)
    count = float(np.asarray(count))
    _load_per_parameter(optimizer, model, lambda name: {
        "step": torch.tensor(count), "exp_avg": mu[name],
        "exp_avg_sq": nu[name]})


def load_sgd_state(optimizer: torch.optim.Optimizer,
                   model: torch.nn.Module, opt_state: Any) -> None:
    """Load the optax ``trace`` (heavy-ball momentum) in ``opt_state``
    into ``optimizer``, a ``torch.optim.SGD`` with momentum over
    ``model.parameters()``: per parameter ``momentum_buffer`` = trace
    (both update ``m * buffer + gradient``)."""
    found = _find_fields(opt_state, ("trace",))
    if found is None:
        raise ValueError("no momentum (trace) state in the optimizer state")
    trace = params_state_dict(found[0], model)
    _load_per_parameter(optimizer, model,
                        lambda name: {"momentum_buffer": trace[name]})


def load_ranger_state(optimizer: Ranger, model: torch.nn.Module,
                      opt_state: Any) -> None:
    """Load the reference's ``ranger`` state, a ``LookaheadState(inner,
    slow_params, count)`` whose ``inner`` chain holds the RAdam's
    ``ScaleByAdamState``, into the port's ``Ranger`` over
    ``model.parameters()``: per parameter ``step``, ``exp_avg`` and
    ``exp_avg_sq`` as :func:`load_adam_state` loads them, and ``slow`` =
    slow_params. The Lookahead count must equal the inner count (the
    port keeps one)."""
    found = _find_fields(opt_state, _LOOKAHEAD_FIELDS)
    if found is None:
        raise ValueError("no lookahead state (inner/slow_params/count) in "
                         "the optimizer state")
    inner, slow, count = found
    adam = _find_adam(inner)
    if adam is None:
        raise ValueError("no radam state (count/mu/nu) in the lookahead's "
                         "inner state")
    step = int(np.asarray(adam.count))
    if int(np.asarray(count)) != step:
        raise ValueError(f"lookahead count {int(np.asarray(count))} != "
                         f"inner count {step}")
    mu, nu, slow = (params_state_dict(tree, model)
                    for tree in (adam.mu, adam.nu, slow))
    _load_per_parameter(optimizer, model, lambda name: {
        "step": torch.tensor(float(step)), "exp_avg": mu[name],
        "exp_avg_sq": nu[name], "slow": slow[name]})


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         model: torch.nn.Module, opt_state: Any) -> None:
    """The reference's optimizer state into the port's optimizer of the
    same kind (``train/optimizers.py``): SGD's momentum, ranger's
    Lookahead and RAdam state, or adam's, adamw's and radam's moments and
    count."""
    if isinstance(optimizer, torch.optim.SGD):
        load_sgd_state(optimizer, model, opt_state)
    elif isinstance(optimizer, Ranger):
        load_ranger_state(optimizer, model, opt_state)
    else:
        load_adam_state(optimizer, model, opt_state)


def adam_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module
               ) -> Tuple[int, Dict[str, Any], Dict[str, Any]]:
    """``(count, mu, nu)`` of a ``torch.optim.Adam`` over
    ``model.parameters()``, as reference trees (numpy leaves)."""
    params = dict(model.named_parameters())
    state = optimizer.state
    count = {int(state[p]["step"]) for p in params.values()}
    if len(count) != 1:
        raise ValueError(f"parameters at different Adam steps: {count}")
    mu = params_tree({n: state[p]["exp_avg"] for n, p in params.items()},
                     model)
    nu = params_tree({n: state[p]["exp_avg_sq"] for n, p in params.items()},
                     model)
    return count.pop(), mu, nu
