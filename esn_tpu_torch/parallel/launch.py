"""Run a function on ``n`` ranks of one host, each in a process of its own
(``spawn``), under a ``file://`` rendezvous: the launcher of the dry run,
the tests and the smoke run. ``torchrun`` launches the CLIs the same way
from its environment (``python -m torch.distributed.run --nproc_per_node
W -m esn_tpu_torch.cli.train ...``).

The parent joins every rank within ``timeout`` seconds. A rank that
raises, exits nonzero or outlives the limit makes :func:`run_ranks` kill
the rest and raise, so a hung collective fails the caller instead of
hanging it.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import numpy as np
import torch


class RankFailure(RuntimeError):
    pass


def to_numpy(tree: Any) -> Any:
    """Tensors in ``tree`` (dicts, lists, tuples) as numpy arrays, bf16 as
    f32, so results cross the process boundary by value."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def _rank_main(fn, args, rank, size, init_method, device, threads, results):
    from . import mesh
    try:
        if threads:
            torch.set_num_threads(threads)
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                          WORLD_SIZE=str(size), LOCAL_WORLD_SIZE=str(size))
        mesh.init_data_parallel(device, init_method)
        out = to_numpy(fn(*args))
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        mesh.shutdown()


def run_ranks(fn: Callable, size: int, *args, device: str = "cpu",
              timeout: float = 120.0,
              threads: Optional[int] = 1) -> List[Any]:
    """``[fn(*args) on rank r for r in range(size)]``, each rank a spawned
    process that has joined the group (``device`` "cpu" or "cuda"; the
    backend follows ``mesh.choose_backend``). ``fn`` must be
    importable by name (a module-level function) and return picklable
    values; tensors come back as numpy arrays. ``threads`` sets each
    rank's torch threads (None leaves torch's default)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="esn_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, args, r, size, init, device, threads,
                                   results), daemon=True)
                 for r in range(size)]
        for p in procs:
            p.start()
        out, failure = {}, None
        deadline = time.monotonic() + timeout
        try:
            while len(out) < size and failure is None:
                try:
                    rank, ok, value = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        failure = (f"rank {dead[0]} exited with "
                                   f"{procs[dead[0]].exitcode}")
                    elif time.monotonic() > deadline:
                        failure = (f"ranks {sorted(set(range(size)) - set(out))}"
                                   f" did not finish within {timeout:.0f} s")
                    continue
                if ok:
                    out[rank] = value
                else:
                    failure = f"rank {rank} raised:\n{value}"
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0)
                       if failure is None else 1.0)
                if failure is None and p.exitcode != 0:
                    failure = f"a rank exited with {p.exitcode}"
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
            results.close()
    if failure is not None:
        raise RankFailure(failure)
    return [out[r] for r in range(size)]


def assert_ranks_equal(values: List[Any]) -> None:
    """Every rank returned the same numbers, bit for bit."""
    first = values[0]
    for r, v in enumerate(values[1:], 1):
        _equal(first, v, f"rank {r}")


def _equal(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), where
