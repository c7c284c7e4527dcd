"""Parallelism over ``torch.distributed``: data parallelism (one rank a
card, the state replicated, the batch split on its leading dimension) and
spatial sharding (an image's height split over the ranks).

Counterpart of ``cswin_simam_unet_tpu/parallel/``: ``mesh.py`` and
``distributed.py``, and ``spatial.py`` (the H-sharded UNet and its halo,
all-gather and moment collectives) and ``spatial_cswin.py`` (the H-sharded
CSWin-UNet).  The tensor-parallel rules (``sharding.py``) are ROADMAP queue
A item 9d.
"""

from .distributed import (global_batch_from_local, initialize_runtime, process_local_indices,
                          rank_device, run_ranks)
from .mesh import (BatchSharding, Mesh, all_reduce_sum, batch_sharding, make_mesh,
                   replicas_equal, replicated, shard_state, state_sharding)
from .spatial import (gather_rows, halo_pad, shard_rows, spatial_batchnorm, spatial_conv3x3,
                      spatial_simam, spatial_stripe_attention, spatial_unet_apply,
                      validate_spatial_geometry)
from .spatial_cswin import spatial_cswin_apply, validate_spatial_cswin

__all__ = ["BatchSharding", "Mesh", "all_reduce_sum", "batch_sharding", "gather_rows",
           "global_batch_from_local", "halo_pad", "initialize_runtime", "make_mesh",
           "process_local_indices", "rank_device", "replicas_equal", "replicated", "run_ranks",
           "shard_rows", "shard_state", "spatial_batchnorm", "spatial_conv3x3",
           "spatial_cswin_apply", "spatial_simam", "spatial_stripe_attention",
           "spatial_unet_apply", "state_sharding", "validate_spatial_cswin",
           "validate_spatial_geometry"]
