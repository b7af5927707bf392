"""The data-parallel world (counterpart of ``esn_tpu/parallel/mesh.py``).

The reference shards the global batch over a ``data`` mesh axis and lets
XLA's global-view autodiff take every batch statistic over the whole
batch. The port runs one process per rank under ``torch.distributed``
and keeps that meaning by hand: rank ``r`` computes a loss ``L_r`` with
``sum_r L_r`` the reference's loss on the global batch, every global
quantity a rank needs comes from a collective whose backward sums the
ranks' upstream gradients (:func:`global_sum`, :func:`gather_rows`), and
the gradients are summed over the ranks (:func:`all_reduce_grads`).

Rank ``r`` of ``W`` holds rows ``[r*B/W, (r+1)*B/W)`` of a batch of ``B``
(:func:`rank_rows`); under ``grad_accum = k`` it holds its part of each
microbatch ``[i*B/k, (i+1)*B/k)``. A batch that the world does not divide
raises: the reference would use fewer devices, but a launched world
cannot shrink.

Under spatial sharding (``parallel.spatial``) the world is the
reference's ``(data, model)`` mesh: rank ``r`` of ``W = n_data x S``
sits at data index ``r // S`` and model index ``r % S``
(:func:`set_spatial`), the batch splits by the data index over
``n_data`` and image height over the ``S`` ranks of a model group. With
``S = 1`` the data index is the rank and ``n_data`` is ``W``.

The world comes from the launcher's environment (``torchrun``'s
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``). The
backend is ``nccl`` when every rank of the host has a card of its own and
``gloo`` otherwise (several ranks on one card, or the CPU): a rule, not
an option; it is printed, and a failure to initialise raises. Only ``all_reduce``, ``broadcast`` and ``barrier`` are
used (gloo has no ``all_gather`` of CUDA tensors), always in f32, f64 or
int64. With no group every helper is the identity, so a one-process run
is unchanged.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"

_DEVICE: Optional[torch.device] = None
# the model axis: its size and this rank's model group (None at S = 1);
# every layout's groups, made once a process group (``set_spatial``)
_SPATIAL = 1
_MODEL_GROUP = None
_MODEL_GROUPS: Dict[int, List] = {}


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the data-parallel world (``backend`` None:
    no group, one process)."""
    rank: int
    size: int
    local_rank: int
    backend: Optional[str]
    device: torch.device
    spatial: int = 1

    @property
    def n_data(self) -> int:
        """The ranks along the data axis."""
        return self.size // self.spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def model_index(self) -> int:
        return self.rank % self.spatial


def active() -> bool:
    """Whether a process group is up."""
    return dist.is_available() and dist.is_initialized()


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def world(device: str = "cpu") -> World:
    """The current world; with no group, one process on ``device``."""
    if not active():
        return World(0, 1, 0, None, torch.device(device))
    rank = dist.get_rank()
    return World(rank, dist.get_world_size(), _env_int("LOCAL_RANK", rank),
                 dist.get_backend(), _DEVICE or torch.device(device),
                 _SPATIAL)


def set_spatial(n_spatial: int) -> World:
    """Lay the world out as ``(data, model)`` with ``n_spatial`` ranks on
    the model axis (the reference's ``devices.reshape(n_data,
    n_spatial)``): rank ``r`` at data index ``r // n_spatial``, model
    index ``r % n_spatial``. Every rank creates every model group, in the
    same order, as ``dist.new_group`` requires, the first time this
    ``n_spatial`` is laid out in the process group; a later call reuses
    them. ``n_spatial = 1`` is the data-parallel world. A world that
    ``n_spatial`` does not divide raises: the reference would use fewer
    devices, but a launched world cannot shrink."""
    global _SPATIAL, _MODEL_GROUP
    size = dist.get_world_size() if active() else 1
    if n_spatial < 1 or size % n_spatial:
        raise ValueError(
            f"{size} rank(s) are not divisible by spatial={n_spatial}: a "
            f"launched world cannot shrink, so launch a multiple of "
            f"{n_spatial} ranks (n_data x {n_spatial})")
    _SPATIAL, _MODEL_GROUP = 1, None
    if n_spatial > 1:
        if n_spatial not in _MODEL_GROUPS:
            _MODEL_GROUPS[n_spatial] = [
                dist.new_group(list(range(d * n_spatial,
                                          (d + 1) * n_spatial)))
                for d in range(size // n_spatial)]
        _MODEL_GROUP = _MODEL_GROUPS[n_spatial][dist.get_rank() // n_spatial]
        _SPATIAL = n_spatial
    return world()


def model_group():
    """This rank's model group (None at ``S = 1``)."""
    return _MODEL_GROUP


def rank_device(device: str, local_rank: int) -> torch.device:
    """Rank ``local_rank``'s device: ``cuda:(local_rank % cards)``, or the
    CPU when asked for."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; run on the CPU with device='cpu' "
                           "(the CLIs' --cuda False)")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """``nccl`` when every rank of the host has a card of its own, else
    ``gloo`` (ranks sharing a card, or on the CPU)."""
    if (device.type == "cuda"
            and torch.cuda.device_count() >= local_world_size):
        return "nccl"
    return "gloo"


def init_data_parallel(device: str = "cuda",
                       init_method: Optional[str] = None) -> World:
    """Join the data-parallel group and return the world.

    The world comes from the launcher's environment (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), the rendezvous from
    ``init_method`` (``env://`` when None) and the backend from
    :func:`choose_backend`. A world of one with no ``init_method`` joins
    nothing (the one-process path); an explicit ``init_method`` makes a
    group even of one. A group that is already up is returned as it is.
    """
    global _DEVICE
    if active():
        return world(device)
    size = _env_int("WORLD_SIZE", 1)
    if size <= 1 and init_method is None:
        return world(device)
    rank = _env_int("RANK", 0)
    local_size = _env_int("LOCAL_WORLD_SIZE", size)
    dev = rank_device(device, _env_int("LOCAL_RANK", rank))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, local_size)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=size)
    _DEVICE = dev
    if rank == 0:
        why = ("every rank has a card of its own" if backend == "nccl"
               else f"{local_size} ranks on {dev.type}"
               + (f" and {torch.cuda.device_count()} card(s)"
                  if dev.type == "cuda" else ""))
        print(f"[esn_tpu_torch.parallel] {size} rank(s), backend {backend} "
              f"({why})", flush=True)
    return world(device)


def shutdown() -> None:
    """Leave the group, if one is up."""
    global _DEVICE, _SPATIAL, _MODEL_GROUP
    if active():
        dist.destroy_process_group()
    _DEVICE, _SPATIAL, _MODEL_GROUP = None, 1, None
    _MODEL_GROUPS.clear()


# --------------------------------------------------------------- collectives
_WIRE = {torch.float64: torch.float64, torch.int64: torch.int64}


def _wire_dtype(dtype: torch.dtype) -> torch.dtype:
    """f64 and int64 stay; other floats go as f32, other integers and
    bools as int64."""
    if dtype in _WIRE:
        return _WIRE[dtype]
    if dtype.is_floating_point:
        return torch.float32
    return torch.int64


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where a collective of ``t`` runs: NCCL takes only the rank's card."""
    if dist.get_backend() == "nccl" and _DEVICE is not None:
        return _DEVICE
    return t.device


def _all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` (f32, f64 or int64) over the ranks (of ``group``; the
    world when None), in place."""
    if t.dtype not in (torch.float32, torch.float64, torch.int64):
        raise TypeError(f"collectives take f32, f64 or int64, not {t.dtype}")
    if group is None:
        dist.all_reduce(t)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, in ``t``'s dtype, carrying no
    gradient (summed in f32, f64 or int64); ``t`` itself with no group."""
    if not active():
        return t
    buf = t.detach().to(device=_comm_device(t), dtype=_wire_dtype(t.dtype),
                        copy=True)
    return _all_reduce_(buf).to(device=t.device, dtype=t.dtype)


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_sum(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank. Its backward sums
    the ranks' upstream gradients: with each rank's loss a part of the
    global one, the gradient of ``x`` is that of the global loss. ``x``
    itself with no group."""
    return _GlobalSum.apply(x) if active() else x


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        w = world()
        n = x.shape[0]
        buf = torch.zeros((w.size * n,) + tuple(x.shape[1:]),
                          dtype=_wire_dtype(x.dtype), device=_comm_device(x))
        buf[w.rank * n:(w.rank + 1) * n] = x
        ctx.rows, ctx.device = (w.rank * n, (w.rank + 1) * n), x.device
        return _all_reduce_(buf).to(device=x.device, dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g)[ctx.rows[0]:ctx.rows[1]]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0 in rank order (each rank
    gives as many rows), on every rank: an all-reduce of a zero buffer in
    which each rank writes its own rows. The backward sums the ranks'
    upstream gradients and keeps this rank's rows. ``x`` with no group."""
    return _GatherRows.apply(x) if active() else x


def all_reduce_grads(parameters: Iterable[torch.Tensor],
                     *extra: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Sum the parameters' gradients over the ranks in place, in one flat
    buffer (f32; f64 when a gradient is f64), with the scalars ``extra``
    summed in the same buffer; returns the summed ``extra``. Parameters
    without a gradient are left out (alike on every rank)."""
    if not active():
        return extra
    grads = [p.grad for p in parameters if p.grad is not None]
    dtype = torch.float64 if any(g.dtype == torch.float64 for g in grads) \
        else torch.float32
    parts = [g.reshape(-1) for g in grads] + [e.reshape(-1) for e in extra]
    if not parts:
        return extra
    dev = _comm_device(parts[0])
    flat = torch.cat([p.to(device=dev, dtype=dtype) for p in parts])
    _all_reduce_(flat)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    out = []
    for e in extra:
        out.append(flat[at:at + e.numel()].view_as(e).to(
            device=e.device, dtype=e.dtype))
        at += e.numel()
    return tuple(out)


def _broadcast_(t: torch.Tensor, src: int) -> None:
    buf = t.detach().to(device=_comm_device(t), dtype=_wire_dtype(t.dtype),
                        copy=True)
    dist.broadcast(buf, src)
    with torch.no_grad():
        t.copy_(buf)


def broadcast_state(module: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    src: int = 0) -> None:
    """Make every rank's parameters, buffers and optimizer state rank
    ``src``'s. Nothing with no group."""
    if not active():
        return
    for t in module.state_dict().values():
        _broadcast_(t, src)
    if optimizer is not None:
        for state in optimizer.state.values():
            for v in state.values():
                if isinstance(v, torch.Tensor):
                    _broadcast_(v, src)


def barrier() -> None:
    if active():
        dist.barrier()


def rank_devices() -> List[str]:
    """Every rank's device, in rank order (``cpu``, ``cuda:i``)."""
    w = world()
    if not active():
        return [str(w.device)]
    idx = -1 if w.device.type == "cpu" else (w.device.index or 0)
    buf = torch.zeros(w.size, dtype=torch.int64)
    buf[w.rank] = idx
    buf = all_sum(buf)
    return ["cpu" if i < 0 else f"cuda:{i}" for i in buf.tolist()]


# ----------------------------------------------------------------- batches
def rank_rows(n: int, grad_accum: int = 1,
              w: Optional[World] = None) -> np.ndarray:
    """The global rows of a batch of ``n`` that this rank holds: its part
    ``[d*m/D, (d+1)*m/D)`` of each of the ``grad_accum`` microbatches of
    ``m = n/grad_accum`` rows, in order, with ``d`` its data index and
    ``D`` the ranks on the data axis (its rank and ``W`` at ``S = 1``).
    Raises when ``grad_accum x D`` does not divide ``n``."""
    w = w or world()
    nd, d = w.n_data, w.data_index
    if n % (grad_accum * nd):
        axis = f"{nd} rank(s)" if w.spatial == 1 else \
            f"{nd} data rank(s) ({w.size} ranks / spatial={w.spatial})"
        raise ValueError(
            f"batch {n} is not divisible by grad_accum={grad_accum} x "
            f"{axis}: a launched world cannot shrink, so choose a batch "
            f"size the world divides")
    mb = n // grad_accum
    part = mb // nd
    return np.concatenate([np.arange(i * mb + d * part,
                                     i * mb + (d + 1) * part)
                           for i in range(grad_accum)])


def _take(v, rows: np.ndarray, n: int, contiguous: Optional[slice]):
    if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim and \
            v.shape[0] == n:
        if contiguous is not None:
            return v[contiguous]
        return v[torch.from_numpy(rows).to(v.device)] \
            if isinstance(v, torch.Tensor) else v[rows]
    if isinstance(v, (list, tuple)) and len(v) == n:
        return type(v)(v[i] for i in rows)
    return v


def shard_batch(batch: Dict, grad_accum: int = 1,
                w: Optional[World] = None) -> Dict:
    """This rank's rows (:func:`rank_rows`) of every array, tensor and list
    of ``batch`` whose leading size is the batch's; other values pass
    through. The batch itself on a data axis of one."""
    w = w or world()
    if w.n_data == 1:
        return batch
    n = next(len(v) for v in batch.values()
             if isinstance(v, (np.ndarray, torch.Tensor)))
    rows = rank_rows(n, grad_accum, w)
    contiguous = slice(int(rows[0]), int(rows[-1]) + 1) \
        if rows[-1] - rows[0] + 1 == len(rows) else None
    return {k: _take(v, rows, n, contiguous) for k, v in batch.items()}


def pad_batch_to(batch: Dict[str, np.ndarray], target_b: int
                 ) -> Tuple[Dict[str, np.ndarray], int]:
    """Pad every array's leading dim up to ``target_b`` (numpy, edge
    mode); other values pass through. Returns (padded batch, real
    count)."""
    def pad(x):
        if not isinstance(x, np.ndarray) or x.shape[0] == target_b:
            return x
        if x.shape[0] > target_b:
            raise ValueError(f"batch {x.shape[0]} exceeds pad target "
                             f"{target_b}")
        width = [(0, target_b - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, width, mode="edge")
    real = next(v for v in batch.values()
                if isinstance(v, np.ndarray)).shape[0]
    return {k: pad(v) for k, v in batch.items()}, real


def pad_batch_to_devices(batch: Dict[str, np.ndarray], n_devices: int
                         ) -> Tuple[Dict[str, np.ndarray], int]:
    """Pad the leading dim up to a multiple of ``n_devices``; see
    :func:`pad_batch_to`."""
    b = next(v for v in batch.values() if isinstance(v, np.ndarray)).shape[0]
    return pad_batch_to(batch, b + (-b) % n_devices)
