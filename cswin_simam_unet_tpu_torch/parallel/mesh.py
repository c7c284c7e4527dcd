"""The mesh of a multi-rank run: which rows of a batch each rank takes, the
replicated training state, and the collectives the step makes.

Counterpart of ``cswin_simam_unet_tpu/parallel/mesh.py``.  JAX builds a
``jax.sharding.Mesh`` over its devices, annotates the batch as sharded on
its leading dimension and the state as replicated, and lets XLA insert the
gradient all-reduce.  The port's ranks are processes, one per card, and the
step makes what XLA would: the gradient average, the global batch's
BatchNorm moments and the global batch's loss and metric counts.

:class:`Mesh` is the port's own small record of the process group (its
size, this rank, this rank's device) rather than torch's ``DeviceMesh``:
the data axis needs one group and nothing of DTensor, and ``DeviceMesh``
would also bind one device to each rank, which two ranks sharing one card
(the only multi-rank run this repository can make on its one H100) do not
have.  A mesh has one axis: ``('data',)``, or ``('spatial',)``, over which
``parallel/spatial.py`` and ``parallel/spatial_cswin.py`` shard an image's
height (each rank holds an H-slab of every image; the training step and
``fit`` take no such mesh, as JAX trains on none).  The tensor-parallel
rules (``parallel/sharding.py``) are ROADMAP queue A item 9d.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .distributed import rank_device

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
_TP_ITEM = "tensor-parallel sharding is not ported yet (ROADMAP queue A item 9d)"


@dataclass(frozen=True)
class Mesh:
    """The ranks of the default process group along the mesh's one axis
    (``data`` or ``spatial``).  Collectives over a mesh of one rank are
    no-ops."""
    size: int
    rank: int
    device: torch.device
    axis_names: Tuple[str, ...] = (DATA_AXIS,)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that writes files and prints."""
        return self.rank == 0

    def all_reduce_(self, t: torch.Tensor, op=None) -> torch.Tensor:
        """Sum (or ``op``) ``t`` over the ranks, in place."""
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.size > 1:
            dist.broadcast(t, src)
        return t

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = (DATA_AXIS,), device=None) -> Mesh:
    """The mesh over every rank of the process group (one rank where there
    is none), on this rank's device (``device``, else
    ``distributed.rank_device()``).  A 1-axis mesh over the whole group,
    ``('data',)`` or ``('spatial',)``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    shape = (world,) if shape is None else tuple(shape)
    if len(shape) != 1 or tuple(axis_names) not in ((DATA_AXIS,), (SPATIAL_AXIS,)):
        raise NotImplementedError(f"mesh {shape} over {tuple(axis_names)}: only the "
                                  f"('data',) and ('spatial',) axes exist; {_TP_ITEM}")
    if shape[0] != world:
        raise ValueError(f"mesh shape {shape} needs {shape[0]} processes, have {world}")
    return Mesh(world, rank, rank_device(device), tuple(axis_names))


@dataclass(frozen=True)
class BatchSharding:
    """Which rows of a global batch this rank takes (JAX's ``NamedSharding``
    of the batch).  A batch is split over the ranks when every one of its
    ``grad_accum`` micro-batches splits evenly: rank r then takes share r of
    each global micro-batch, so its local micro-batch i is its part of the
    global micro-batch i.  Any other batch is taken whole by every rank, as
    JAX places such a batch replicated.  ``axis`` None is the replicated
    sharding."""
    mesh: Mesh
    grad_accum: int = 1
    axis: Optional[str] = DATA_AXIS

    def splits(self, batch: int) -> bool:
        n = self.mesh.size
        return self.axis is not None and n > 1 and batch % (n * self.grad_accum) == 0

    def rows(self, batch: int) -> np.ndarray:
        """Indices of this rank's rows of a global batch of ``batch`` rows."""
        if not self.splits(batch):
            return np.arange(batch)
        m = batch // self.grad_accum      # a global micro-batch
        k = m // self.mesh.size            # this rank's share of it
        r = self.mesh.rank
        return np.concatenate([np.arange(i * m + r * k, i * m + (r + 1) * k)
                               for i in range(self.grad_accum)])


def require_data_axis(mesh: Mesh) -> None:
    """Raise unless ``mesh`` is a ``('data',)`` mesh, the one the training
    step, the eval step and ``fit`` take: a ``('spatial',)`` mesh shards an
    image's height, which only the spatial forwards take (JAX trains on no
    spatial mesh either)."""
    names = tuple(mesh.axis_names)
    if names == (SPATIAL_AXIS,):
        raise ValueError("a ('spatial',) mesh shards the image's height: run it through "
                         "parallel.spatial_unet_apply or parallel.spatial_cswin_apply; the "
                         "training step, the eval step and fit take a ('data',) mesh")
    if names != (DATA_AXIS,):
        raise NotImplementedError(f"a mesh over {names}: {_TP_ITEM}")


def batch_sharding(mesh: Mesh, ndim: int = 4, axis: str = DATA_AXIS,
                   grad_accum: int = 1) -> BatchSharding:
    """Shard the leading (batch) dimension over the data axis, in shares of
    each of ``grad_accum`` micro-batches (``ndim`` is JAX's argument: every
    dimension after the first is whole)."""
    require_data_axis(mesh)
    if axis != DATA_AXIS:
        raise ValueError(f"axis {axis!r} is not an axis of the mesh {mesh.axis_names}")
    return BatchSharding(mesh, int(grad_accum), axis)


def replicated(mesh: Mesh) -> BatchSharding:
    """Every rank takes every row."""
    return BatchSharding(mesh, 1, None)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of each rank's input is the sum of
    the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.mesh.all_reduce_(grad.clone(memory_format=torch.contiguous_format)), None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``mesh``."""
    return _AllReduceSum.apply(x, mesh)


def _by_dtype(tensors: Sequence[torch.Tensor]) -> dict:
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bit patterns of ``t``'s elements as int32 (int64 for 8-byte
    elements), equal exactly where the elements are bit-identical."""
    flat = t.detach().reshape(-1)
    if flat.is_floating_point():
        flat = flat.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[flat.element_size()])
    return flat if flat.dtype == torch.int64 else flat.to(torch.int32)


def replicas_equal(tensors: Sequence[torch.Tensor], mesh: Mesh) -> bool:
    """Whether every rank holds bit-identical ``tensors`` (the same shapes
    on every rank): the elementwise max and min over the ranks agree."""
    if mesh.size == 1 or not tensors:
        return True
    equal = True
    for group in _by_dtype([_bits(t).to(mesh.device) for t in tensors]).values():
        lo = torch.cat(group)
        hi = lo.clone()
        mesh.all_reduce_(hi, dist.ReduceOp.MAX)
        mesh.all_reduce_(lo, dist.ReduceOp.MIN)
        equal &= bool(torch.equal(hi, lo))
    return equal


def state_tensors(model: torch.nn.Module, optimizer=None) -> list:
    """The replicated training state: parameters, buffers and the
    optimizer's state tensors, in a fixed order."""
    tensors = list(model.parameters()) + list(model.buffers())
    if optimizer is not None:
        for group in optimizer.param_groups:
            for p in group["params"]:
                state = optimizer.state.get(p, {})
                tensors += [state[k] for k in sorted(state) if isinstance(state[k], torch.Tensor)]
    return tensors


def state_sharding(model: torch.nn.Module, mesh: Mesh, params_shardings=None) -> dict:
    """The sharding of each state tensor (by state-dict name): replicated,
    plain data parallelism.  ``params_shardings`` (tensor parallelism) is
    not ported."""
    if params_shardings is not None:
        raise NotImplementedError(f"state_sharding(params_shardings=...): {_TP_ITEM}")
    rep = replicated(mesh)
    return {name: rep for name in model.state_dict()}


def shard_state(model: torch.nn.Module, optimizer, mesh: Mesh, params_shardings=None) -> None:
    """Replicate the training state over the mesh: rank 0's parameters,
    buffers and optimizer state go to every rank (one broadcast per dtype),
    which is then checked to hold bit-identical values."""
    state_sharding(model, mesh, params_shardings)
    if mesh.size == 1:
        return
    tensors = state_tensors(model, optimizer)
    groups = _by_dtype(tensors)
    sizes = torch.tensor([sum(t.numel() for t in groups[d]) for d in sorted(groups, key=str)],
                         dtype=torch.int64, device=mesh.device)
    if not replicas_equal([sizes], mesh):
        raise ValueError("shard_state: the ranks' models or optimizer states differ in "
                         "structure (tensor counts per dtype)")
    with torch.no_grad():
        for dtype, group in groups.items():
            flat = mesh.broadcast_(torch.cat([t.detach().reshape(-1).to(mesh.device)
                                              for t in group]))
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
    if not replicas_equal(tensors, mesh):
        raise RuntimeError("shard_state: the ranks hold different values after the broadcast")
