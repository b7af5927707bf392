"""Data parallelism of the port (counterpart of ``esn_tpu/parallel``):
one process per rank under ``torch.distributed``, computing the
reference's global-batch step (``parallel/mesh.py``). Sharding image
height over devices (the reference's ``parallel/spatial.py``) is not
ported yet (ROADMAP.md, Queue 1)."""
from .mesh import (DATA_AXIS, World, active, all_reduce_grads,  # noqa: F401
                   all_sum, barrier, broadcast_state, gather_rows,
                   global_sum, init_data_parallel, pad_batch_to,
                   pad_batch_to_devices, rank_devices, rank_rows,
                   shard_batch, shutdown, world)
