"""Data parallelism over ``torch.distributed``: one rank a card, the state
replicated, the batch split on its leading dimension.

Counterpart of the data-parallel half of ``cswin_simam_unet_tpu/parallel/``
(``mesh.py``, ``distributed.py``).  The rest of it is ROADMAP queue A items
9b-9d: the H-sharded UNet (``spatial.py``), the H-sharded CSWin-UNet
(``spatial_cswin.py``) and the tensor-parallel rules (``sharding.py``).
"""

from .distributed import (global_batch_from_local, initialize_runtime, process_local_indices,
                          rank_device, run_ranks)
from .mesh import (BatchSharding, Mesh, all_reduce_sum, batch_sharding, make_mesh,
                   replicas_equal, replicated, shard_state, state_sharding)

__all__ = ["BatchSharding", "Mesh", "all_reduce_sum", "batch_sharding",
           "global_batch_from_local", "initialize_runtime", "make_mesh", "process_local_indices",
           "rank_device", "replicas_equal", "replicated", "run_ranks", "shard_state",
           "state_sharding"]
