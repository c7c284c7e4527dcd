"""Parallelism over ``torch.distributed``: data parallelism (one rank a
card, the batch split on its leading dimension), tensor parallelism (the
CSWin blocks' heads and hidden units split over the ``model`` axis of a
``('data', 'model')`` mesh) and spatial sharding (an image's height split
over the ranks).

Counterpart of ``cswin_simam_unet_tpu/parallel/``: ``mesh.py`` and
``distributed.py``, ``sharding.py`` (the partition rules, each parameter's
shard and the Megatron block's collectives), and ``spatial.py`` (the
H-sharded UNet and its halo, all-gather and moment collectives) and
``spatial_cswin.py`` (the H-sharded CSWin-UNet).
"""

from .distributed import (global_batch_from_local, initialize_runtime, process_local_indices,
                          rank_device, run_ranks)
from .mesh import (BatchSharding, Mesh, all_reduce_sum, batch_sharding, gather_state,
                   gather_tensor, make_mesh, replicas_equal, replicated, shard_state,
                   state_sharding)
from .sharding import (ParamSharding, Rule, collectives, params_shardings,
                       partition_rules_cswin)
from .spatial import (gather_rows, halo_pad, shard_rows, spatial_batchnorm, spatial_conv3x3,
                      spatial_simam, spatial_stripe_attention, spatial_unet_apply,
                      validate_spatial_geometry)
from .spatial_cswin import spatial_cswin_apply, validate_spatial_cswin

__all__ = ["BatchSharding", "Mesh", "ParamSharding", "Rule", "all_reduce_sum",
           "batch_sharding", "collectives", "gather_rows", "gather_state", "gather_tensor",
           "global_batch_from_local", "halo_pad", "initialize_runtime", "make_mesh",
           "params_shardings", "partition_rules_cswin", "process_local_indices", "rank_device",
           "replicas_equal", "replicated", "run_ranks", "shard_rows", "shard_state", "spatial_batchnorm", "spatial_conv3x3",
           "spatial_cswin_apply", "spatial_simam", "spatial_stripe_attention",
           "spatial_unet_apply", "state_sharding", "validate_spatial_cswin",
           "validate_spatial_geometry"]
