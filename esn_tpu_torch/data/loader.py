"""Batch loading and device prefetch (counterpart of
``esn_tpu/data/loader.py``).

:class:`BatchLoader` is the reference's: the same order (numpy
``RandomState(seed + epoch)``), the same ``drop_last``, items decoded on
a thread pool and stacked into numpy batches. :func:`device_prefetch`
moves batches to the device one step ahead of the compute: a producer
thread copies each batch into pinned host memory and from there to the
card on a side CUDA stream; the consumer's stream waits on the copy's
event before it touches the batch.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch


class BatchLoader:
    """Shuffling, batching host loader over a dataset (len + __getitem__)."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        limit = (n // self.batch_size) * self.batch_size if self.drop_last \
            else n
        with ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, limit, self.batch_size):
                idx = order[start:start + self.batch_size]
                yield _stack(list(pool.map(self.dataset.__getitem__, idx)))


def _stack(items):
    batch: Dict[str, np.ndarray] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        batch[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) \
            else vals       # e.g. names
    return batch


def device_prefetch(iterator, device: Optional[torch.device | str] = None, *,
                    size: int = 2, keys=("image", "label")):
    """Yield the batches of ``iterator`` with their ``keys`` arrays as
    tensors on ``device``, prepared up to ``size`` batches ahead by a
    producer thread; other fields pass through.

    On a CUDA device each array is copied into a fresh pinned host tensor
    and from there with ``non_blocking=True`` on a side stream; an event
    recorded after the copies is waited on by the consumer's current
    stream before the batch is yielded, and each tensor is marked with
    ``record_stream`` for that stream, so the caching allocator reuses
    its memory only after the consumer's work on it. The pinned buffer
    itself is held by PyTorch's host allocator until its copy has run.
    On the CPU the same code yields ``torch.from_numpy`` views, with no
    stream. A consumer that stops early retires the producer.
    """
    device = torch.device(device or "cpu")
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    errors = []
    stop = threading.Event()

    def put(batch):
        out = dict(batch)
        if stream is None:
            for k in keys:
                if isinstance(out.get(k), np.ndarray):
                    out[k] = torch.from_numpy(out[k])
            return out, None
        with torch.cuda.stream(stream):
            for k in keys:
                if isinstance(out.get(k), np.ndarray):
                    host = torch.from_numpy(out[k]).pin_memory()
                    out[k] = host.to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def enqueue(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in iterator:
                if not enqueue(put(batch)):
                    return      # consumer gone: drop the device batches
        except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
            errors.append(e)
        finally:
            enqueue(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if errors:
                    raise errors[0]
                return
            out, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for k in keys:
                    if isinstance(out.get(k), torch.Tensor):
                        out[k].record_stream(current)
            yield out
    finally:
        # the consumer left (exception, GeneratorExit): unblock the
        # producer, drop what it queued, and wait for it to end
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)
