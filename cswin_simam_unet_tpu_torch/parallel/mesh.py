"""The mesh of a multi-rank run: which rows of a batch each rank takes, the
training state (replicated, or split over a ``model`` axis), and the
collectives the step makes.

Counterpart of ``cswin_simam_unet_tpu/parallel/mesh.py``.  JAX builds a
``jax.sharding.Mesh`` over its devices, annotates the batch as sharded on
its leading dimension and the state as replicated (or, with
``params_shardings``, split over the ``model`` axis), and lets XLA insert
the collectives.  The port's ranks are processes, one per card, and the
step makes what XLA would: the gradient average over the data axis, the
global batch's BatchNorm moments and the global batch's loss and metric
counts; the CSWin blocks make the model axis's sums
(``parallel/sharding.py``).

:class:`Mesh` is the port's own small record of the process group (its
size, this rank, this rank's device, its axes) rather than torch's
``DeviceMesh``: the axes need a group each and nothing of DTensor, and
``DeviceMesh`` would also bind one device to each rank, which two ranks
sharing one card (the only multi-rank run this repository can make on its
one H100) do not have.  A mesh is ``('data',)``; ``('spatial',)``, over
which ``parallel/spatial.py`` and ``parallel/spatial_cswin.py`` shard an
image's height (each rank holds an H-slab of every image; the training
step and ``fit`` take no such mesh, as JAX trains on none); or
``('data', 'model')`` of shape (d, m), rank ``i_data * m + i_model`` as
JAX's ``np.array(devices).reshape(shape)`` places them, whose
:meth:`Mesh.along` gives the one-axis mesh of this rank's data group (the
ranks of its model coordinate) and of its model group.  The training step,
the eval step and ``fit`` split batches over ``data``; :func:`shard_state`
with ``params_shardings`` splits the CSWin blocks' parameters over
``model``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .distributed import rank_device
from .sharding import MODEL_AXIS, REPLICATED, attach

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MESH_AXES = ((DATA_AXIS,), (SPATIAL_AXIS,), (DATA_AXIS, MODEL_AXIS))


@dataclass(frozen=True)
class Mesh:
    """The ranks of a mesh: ``size`` of them, this one ``rank`` (row-major
    over the axes), its ``device``.  A one-axis mesh spans the process
    group ``group`` (None: the default group), whose mesh rank r is the
    global rank ``ranks[r]`` (None: r); a mesh of several axes
    (``axis_sizes``) spans the default group and keeps in ``axes`` this
    rank's one-axis mesh along each axis.  Collectives over a mesh of one
    rank are no-ops."""
    size: int
    rank: int
    device: torch.device
    axis_names: Tuple[str, ...] = (DATA_AXIS,)
    axis_sizes: Optional[Tuple[int, ...]] = None
    group: Any = None
    ranks: Optional[Tuple[int, ...]] = None
    axes: Tuple["Mesh", ...] = ()

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes or (self.size,)))

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that writes files and prints."""
        return self.rank == 0

    def along(self, axis: str) -> "Mesh":
        """This rank's one-axis mesh along ``axis``: its ranks that differ
        from this one in that coordinate only."""
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} is not an axis of the mesh {self.axis_names}")
        return self.axes[self.axis_names.index(axis)] if self.axes else self

    def all_reduce_(self, t: torch.Tensor, op=None) -> torch.Tensor:
        """Sum (or ``op``) ``t`` over the ranks, in place."""
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (the same shape on every rank), in mesh-rank
        order."""
        if self.size == 1:
            return [t]
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return parts

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.size > 1:
            dist.broadcast(t, self.ranks[src] if self.ranks else src, group=self.group)
        return t

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = (DATA_AXIS,), device=None) -> Mesh:
    """The mesh over every rank of the process group (one rank where there
    is none), on this rank's device (``device``, else
    ``distributed.rank_device()``): a one-axis mesh ``('data',)`` or
    ``('spatial',)`` over the whole group, or ``shape=(d, m),
    axis_names=('data', 'model')`` over d * m ranks, whose data and model
    groups every rank creates, in one order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    names = tuple(axis_names)
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    if names not in MESH_AXES or len(shape) != len(names):
        raise ValueError(f"mesh {shape} over {names}: the port's meshes are "
                         f"{', '.join(map(str, MESH_AXES))}, one size an axis")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} processes, "
                         f"have {world}")
    dev = rank_device(device)
    if len(names) == 1:
        return Mesh(world, rank, dev, names)
    d, m = shape
    coords = divmod(rank, m)
    members = ([tuple(i * m + j for i in range(d)) for j in range(m)],   # data groups
               [tuple(i * m + j for j in range(m)) for i in range(d)])   # model groups
    axes = []
    for axis, groups, mine in ((DATA_AXIS, members[0], coords[1]),
                               (MODEL_AXIS, members[1], coords[0])):
        made = [dist.new_group(list(g)) if world > 1 else None for g in groups]
        axes.append(Mesh(len(groups[mine]), groups[mine].index(rank), dev, (axis,),
                         group=made[mine], ranks=groups[mine]))
    return Mesh(world, rank, dev, names, shape, axes=tuple(axes))


@dataclass(frozen=True)
class BatchSharding:
    """Which rows of a global batch this rank takes (JAX's ``NamedSharding``
    of the batch), ``mesh`` being the data axis's one-axis mesh.  A batch is
    split over the ranks when every one of its ``grad_accum`` micro-batches
    splits evenly: rank r then takes share r of each global micro-batch, so
    its local micro-batch i is its part of the global micro-batch i.  Any
    other batch is taken whole by every rank, as JAX places such a batch
    replicated.  ``axis`` None is the replicated sharding."""
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
    """Raise unless ``mesh`` is a ``('data',)`` or ``('data', 'model')``
    mesh, the ones the training step, the eval step and ``fit`` take: a
    ``('spatial',)`` mesh shards an image's height, which only the spatial
    forwards take (JAX trains on no spatial mesh either)."""
    names = tuple(mesh.axis_names)
    if names == (SPATIAL_AXIS,):
        raise ValueError("a ('spatial',) mesh shards the image's height: run it through "
                         "parallel.spatial_unet_apply or parallel.spatial_cswin_apply; the "
                         "training step, the eval step and fit take a ('data',) or "
                         "('data', 'model') mesh")
    if names not in ((DATA_AXIS,), (DATA_AXIS, MODEL_AXIS)):
        raise ValueError(f"a mesh over {names}: the training step, the eval step and fit take "
                         "a ('data',) or ('data', 'model') mesh")


def batch_sharding(mesh: Mesh, ndim: int = 4, axis: str = DATA_AXIS,
                   grad_accum: int = 1) -> BatchSharding:
    """Shard the leading (batch) dimension over the data axis, in shares of
    each of ``grad_accum`` micro-batches (``ndim`` is JAX's argument: every
    dimension after the first is whole).  The model ranks of one data
    coordinate take the same rows."""
    require_data_axis(mesh)
    if axis != DATA_AXIS:
        raise ValueError(f"axis {axis!r} is not an axis of the mesh {mesh.axis_names}")
    return BatchSharding(mesh.along(DATA_AXIS), int(grad_accum), axis)


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


def _named_state(model: torch.nn.Module, optimizer=None) -> list:
    """(state-dict name of the parameter or buffer, tensor) of the training
    state: parameters, buffers and the optimizer's state tensors (named by
    their parameter), in a fixed order."""
    named = list(model.named_parameters()) + list(model.named_buffers())
    if optimizer is not None:
        names = {id(p): n for n, p in model.named_parameters()}
        for group in optimizer.param_groups:
            for p in group["params"]:
                state = optimizer.state.get(p, {})
                named += [(names.get(id(p)), state[k]) for k in sorted(state)
                          if isinstance(state[k], torch.Tensor)]
    return named


def state_tensors(model: torch.nn.Module, optimizer=None) -> list:
    """The training state: parameters, buffers and the optimizer's state
    tensors, in a fixed order."""
    return [t for _, t in _named_state(model, optimizer)]


def _is_split(t: torch.Tensor, name, shardings: dict) -> bool:
    """Whether ``t`` (the state tensor of ``name``) is split: a sharded
    parameter or an optimizer moment of its shape (a step count is not)."""
    s = shardings.get(name, REPLICATED)
    return not s.replicated and t.ndim > s.dim


def state_sharding(model: torch.nn.Module, mesh: Mesh, params_shardings=None) -> dict:
    """The sharding (``parallel.sharding.ParamSharding``) of each state
    tensor by state-dict name: replicated, plain data parallelism, or with
    ``params_shardings`` (:func:`parallel.params_shardings` of the model on
    this mesh) each parameter's own, which the optimizer's moments of it
    share (JAX's ``state_sharding`` matches them by path suffix)."""
    shardings = params_shardings or {}
    unknown = sorted(set(shardings) - {n for n, _ in model.named_parameters()})
    if unknown:
        raise ValueError(f"params_shardings names no parameter of the model: {unknown[:3]}")
    return {name: shardings.get(name, REPLICATED) for name in model.state_dict()}


def shard_state(model: torch.nn.Module, optimizer, mesh: Mesh, params_shardings=None) -> None:
    """Place the training state on the mesh: rank 0's parameters, buffers
    and optimizer state go to every rank (one broadcast per dtype).  With
    ``params_shardings`` each split parameter then keeps this rank's shard
    (its ``.data`` narrowed in place, so an optimizer built before keeps
    working), and so do its optimizer moments, and each CSWin block learns
    its model group, its branches' local heads and their ``head0``
    (``parallel/sharding.py``).  The replicated state is then checked to be
    bit-identical over the mesh, the split state over the data axis."""
    if getattr(model, "tp_shardings", None):
        raise ValueError("shard_state: the model is split already; it takes a whole model")
    shardings = state_sharding(model, mesh, params_shardings)
    named = _named_state(model, optimizer)
    tensors = [t for _, t in named]
    if mesh.size > 1:
        groups = _by_dtype(tensors)
        sizes = torch.tensor([sum(t.numel() for t in groups[d])
                              for d in sorted(groups, key=str)],
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
    split = [_is_split(t, n, shardings) for n, t in named]
    if any(split):
        model_mesh = mesh.along(MODEL_AXIS)
        attach(model, model_mesh, shardings)
        with torch.no_grad():
            for (name, t), s in zip(named, split):
                if s:
                    t.data = shardings[name].shard(t.data, model_mesh.rank)
                    t.grad = None
        model.tp_shardings = {n: s for n, s in shardings.items() if not s.replicated}
    if not replicas_equal([t for t, s in zip(tensors, split) if not s], mesh):
        raise RuntimeError("shard_state: the ranks hold different values after the broadcast")
    if any(split) and not replicas_equal([t for t, s in zip(tensors, split) if s],
                                         mesh.along(DATA_AXIS)):
        raise RuntimeError("shard_state: the data axis holds different shards")


def gather_tensor(model: torch.nn.Module, name: str, t: torch.Tensor, mesh: Mesh):
    """The whole tensor of which ``t`` is this rank's shard: ``t`` a state
    tensor of the parameter ``name`` (the parameter, its gradient or an
    optimizer moment) of a model that :func:`shard_state` split, gathered
    over the model axis and put together in its sharding's order; a copy of
    ``t`` where it is not split.  Every rank of the model group calls it."""
    shardings = getattr(model, "tp_shardings", None) or {}
    t = t.detach()
    if not _is_split(t, name, shardings):
        return t.clone()
    s = shardings[name]
    shape = list(t.shape)
    shape[s.dim] = sum(len(i) for i in s.indices)
    out = torch.empty(shape, dtype=t.dtype, device=t.device)
    for r, part in enumerate(mesh.along(MODEL_AXIS).all_gather(t)):
        out.index_copy_(s.dim, s.index(r, t.device), part)
    return out


def gather_state(model: torch.nn.Module, optimizer, mesh: Mesh) -> tuple:
    """The full training state of a model that :func:`shard_state` split:
    (the model's state dict, {parameter name: {optimizer state key:
    tensor}}), every split tensor gathered by :func:`gather_tensor`; the
    same on every rank.  A replicated state comes back as it is."""
    state = {name: gather_tensor(model, name, t, mesh)
             for name, t in model.state_dict(keep_vars=True).items()}
    opt_state = {}
    if optimizer is not None:
        for name, p in model.named_parameters():
            opt_state[name] = {k: gather_tensor(model, name, v, mesh)
                               if isinstance(v, torch.Tensor) else v
                               for k, v in optimizer.state.get(p, {}).items()}
    return state, opt_state
