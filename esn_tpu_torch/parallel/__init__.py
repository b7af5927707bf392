"""Parallelism of the port (counterpart of ``esn_tpu/parallel``): one
process per rank under ``torch.distributed``, computing the reference's
global-batch step (``parallel/mesh.py``), with image height sharded over
a ``model`` axis of ranks under ``parallel/spatial.py``."""
from .mesh import (DATA_AXIS, World, active, all_reduce_grads,  # noqa: F401
                   all_sum, barrier, broadcast_state,
                   gather_rows, global_sum, init_data_parallel, pad_batch_to,
                   pad_batch_to_devices, rank_devices, rank_rows, set_spatial,
                   shard_batch, shutdown, world)
