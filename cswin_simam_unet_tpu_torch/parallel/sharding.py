"""Tensor parallelism of the CSWin block over the ``model`` axis of a
``('data', 'model')`` mesh: the partition rules, each parameter's shard,
and the two collectives of the Megatron pattern.

Counterpart of ``cswin_simam_unet_tpu/parallel/sharding.py``.  The rules
are JAX's eight (``partition_rules_cswin``), over the port's state-dict
names in torch's layout: the qkv projection and the MLP's fc1 split their
output features (dimension 0 of the weight), proj and fc2 their input
features (dimension 1), and the LePE ``get_v`` convolutions follow their
channels; proj's and fc2's biases stay replicated.  JAX annotates the
parameters and lets XLA place the collectives; here each rank holds its
own shard and computes its own heads and hidden units, and the block makes
the collectives itself (:class:`BlockShard`): before qkv and before fc1 an
identity whose backward sums the input's gradient over the model group,
after proj and after fc2 a sum over the model group whose backward is the
identity, the biases added after the sum.

Two differences from JAX's shards, both forced by a rank computing its
heads alone (ROADMAP queue C, deliberate differences):

* a rank's share of qkv, proj and ``get_v`` is **head-aligned, per
  branch**: of each stripe branch of ``hb`` heads (``num_heads / 2`` in
  stages 1-3, ``num_heads`` in the last), model rank r owns heads
  [r * hb / m, (r + 1) * hb / m), i.e. those heads' channels within q, k
  and v and within each branch, where XLA stores contiguous slices of the
  weights and reshards inside the step;
* a block's attention group (qkv, proj, ``get_v``) is replicated unless
  ``hb`` divides by the model axis's size m (JAX asks each dimension to
  divide); its MLP still splits, contiguously, where 4C divides.

A rank's attention then runs K-A / K-A' (``ops/stripe_attention.py``) on
``hb / m`` heads of the same head dimension, its dropout mask keyed on the
layer's head numbers (``head0``); fc1's dropout draws the mask of the whole
hidden tensor and keeps this rank's columns, so that every draw equals one
process's.  LayerNorms, residuals, merges, CARAFEs, skips and the head stay
replicated and run on every model rank as on one process.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import torch

MODEL_AXIS = "model"


class Rule(NamedTuple):
    """Parameters whose state-dict name matches ``pattern`` split dimension
    ``dim`` over the mesh axis ``axis``."""
    pattern: str
    dim: int
    axis: str


def partition_rules_cswin(model_axis: str = MODEL_AXIS) -> List[Rule]:
    """JAX's rules (``parallel/sharding.py:27-41``) over the port's names,
    dimensions in torch's layout (weights (out, in), convs (out, in/groups,
    k, k))."""
    return [
        Rule(r".*\.qkv\.weight$", 0, model_axis),
        Rule(r".*\.qkv\.bias$", 0, model_axis),
        Rule(r".*\.proj\.weight$", 1, model_axis),
        Rule(r".*\.mlp\.fc1\.weight$", 0, model_axis),
        Rule(r".*\.mlp\.fc1\.bias$", 0, model_axis),
        Rule(r".*\.mlp\.fc2\.weight$", 1, model_axis),
        Rule(r".*\.attns\.\d+\.get_v\.weight$", 0, model_axis),
        Rule(r".*\.attns\.\d+\.get_v\.bias$", 0, model_axis),
    ]


@dataclass(frozen=True)
class ParamSharding:
    """A tensor's sharding: replicated (``dim`` None), or split along
    ``dim`` over the model axis, rank j of that axis holding the entries
    ``indices[j]`` of the dimension, in that order."""
    dim: Optional[int] = None
    indices: Tuple[Tuple[int, ...], ...] = ()

    @property
    def replicated(self) -> bool:
        return self.dim is None

    def index(self, coord: int, device=None) -> torch.Tensor:
        return torch.tensor(self.indices[coord], dtype=torch.long, device=device)

    def shard(self, t: torch.Tensor, coord: int) -> torch.Tensor:
        """The entries of the full tensor ``t`` that rank ``coord`` holds."""
        if self.replicated:
            return t
        return t.index_select(self.dim, self.index(coord, t.device)).contiguous()


REPLICATED = ParamSharding()

# what each sharded parameter of a CSWin block is: its suffix, the group it
# belongs to, the dimension it splits
_ATTN_KINDS = {"qkv.weight": 0, "qkv.bias": 0, "proj.weight": 1}
_MLP_KINDS = {"mlp.fc1.weight": 0, "mlp.fc1.bias": 0, "mlp.fc2.weight": 1}
_GET_V = re.compile(r"^attns\.(\d+)\.get_v\.(weight|bias)$")


_DIMS = {**_ATTN_KINDS, **_MLP_KINDS}


def _is_attn(kind: str) -> bool:
    return kind in _ATTN_KINDS or bool(_GET_V.match(kind))


def _split_dim(kind: Optional[str]) -> Optional[int]:
    """The dimension along which a block parameter (its name within the
    block) can split, or None for one that cannot."""
    if kind is None:
        return None
    return _DIMS.get(kind, 0 if _GET_V.match(kind) else None)


def _blocks(model: torch.nn.Module) -> dict:
    from ..models.layers import CSWinBlock
    return {name: mod for name, mod in model.named_modules() if isinstance(mod, CSWinBlock)}


def _owner(blocks: dict, name: str) -> Tuple[Optional[str], Optional[str]]:
    """(the CSWin block holding parameter ``name``, ``name`` within it), or
    (None, None)."""
    for bname in blocks:
        if name.startswith(bname + "."):
            return bname, name[len(bname) + 1:]
    return None, None


def _branch_heads(block) -> Tuple[int, int]:
    """(branches, heads a branch) of a CSWin block."""
    return len(block.attns), block.attns[0].num_heads


def _heads_of(block, m: int) -> Optional[List[List[int]]]:
    """For each model rank, its channels of the block's C attention
    channels (branch after branch, each rank's heads of each branch), or
    None where a branch's heads do not divide by m."""
    nb, hb = _branch_heads(block)
    if hb % m:
        return None
    cb = block.attns[0].get_v.weight.shape[0]
    per = cb // m  # a rank's channels of a branch
    return [[b * cb + c for b in range(nb) for c in range(r * per, (r + 1) * per)]
            for r in range(m)]


def _param_sharding(block, kind: str, dim: int, size: int, m: int) -> ParamSharding:
    """The sharding of the block parameter ``kind`` (its name within the
    block) split along ``dim`` over m ranks, or REPLICATED where it does
    not divide."""
    if _is_attn(kind):
        own = _heads_of(block, m)
        if own is None:
            return REPLICATED
        C = sum(a.get_v.weight.shape[0] for a in block.attns)
        if _GET_V.match(kind):  # a branch's own channels
            per = block.attns[0].get_v.weight.shape[0] // m
            idx = [list(range(r * per, (r + 1) * per)) for r in range(m)]
        elif kind.startswith("qkv"):  # q, k and v: each rank's channels of each
            idx = [[part * C + c for part in range(3) for c in own[r]] for r in range(m)]
        else:
            idx = own
    else:
        if size % m:
            return REPLICATED
        per = size // m
        idx = [list(range(r * per, (r + 1) * per)) for r in range(m)]
    return ParamSharding(dim, tuple(tuple(i) for i in idx))


def params_shardings(model: torch.nn.Module, mesh, rules=None) -> dict:
    """Each parameter's :class:`ParamSharding` under ``rules``
    (:func:`partition_rules_cswin` by default), by state-dict name.  The
    first rule whose pattern matches a name decides; it applies where it
    divides (see the module's docstring: a block's attention group by whole
    heads of each branch), else the parameter is replicated, as it is where
    no rule matches or the mesh lacks the rule's axis.  A rule may name the
    parameters of a CSWin block's attention group and MLP, at the
    dimensions of :func:`partition_rules_cswin`, and nothing else: no other
    parameter can run split."""
    rules = partition_rules_cswin() if rules is None else rules
    sizes = mesh.shape
    blocks = _blocks(model)
    if any(getattr(b, "tp", None) is not None for b in blocks.values()):
        raise ValueError("params_shardings takes the whole model; this one is already sharded")
    out = {}
    for name, p in model.named_parameters():
        out[name] = REPLICATED
        rule = next((r for r in rules if re.match(r.pattern, name)), None)
        if rule is None or rule.axis not in sizes:
            continue
        bname, kind = _owner(blocks, name)
        if rule.axis != MODEL_AXIS or _split_dim(kind) != rule.dim:
            raise ValueError(f"rule {rule.pattern!r} splits {name} along dimension {rule.dim} "
                             f"over {rule.axis!r}: tensor parallelism splits a CSWin block's "
                             "qkv, proj, get_v, fc1 and fc2 only, along "
                             "partition_rules_cswin()'s dimensions, over the 'model' axis")
        out[name] = _param_sharding(blocks[bname], kind, rule.dim, p.shape[rule.dim],
                                    sizes[rule.axis])
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model group."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, shard: "BlockShard") -> torch.Tensor:
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.shard.sum(grad), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group; the backward is the identity."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, shard: "BlockShard") -> torch.Tensor:
        return shard.sum(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


class BlockShard:
    """What one rank holds of a CSWin block under tensor parallelism:
    ``mesh`` (the model axis), whether the attention group is split
    (``attn``; its branches then hold this rank's heads) and the MLP's split
    (``hidden`` = (hidden width, first, last + 1) of this rank's fc1
    columns, None where the MLP is replicated).  ``all_reduces`` and
    ``bytes`` count the block's model-group sums (:func:`collectives`)."""

    def __init__(self, mesh, attn: bool, hidden: Optional[Tuple[int, int, int]]):
        self.mesh, self.attn, self.hidden = mesh, attn, hidden
        self.all_reduces = self.bytes = 0

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        if self.mesh.size > 1:
            self.mesh.all_reduce_(out)
            self.all_reduces += 1
            self.bytes += out.numel() * out.element_size()
        return out

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a column-split layer (qkv, fc1): x in the forward,
        the gradient summed over the model group in the backward."""
        return _CopyToModel.apply(x, self)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        """The output of a row-split layer (proj, fc2): the partial products
        summed over the model group; the backward passes the gradient
        through."""
        return _ReduceFromModel.apply(x, self)


def collectives(model: torch.nn.Module, reset: bool = False) -> dict:
    """The model-group all-reduces the CSWin blocks of ``model`` made
    (forward and backward) and their bytes, since they were split or last
    reset; ``reset`` sets the counts to 0 after reading them."""
    out = {"all_reduces": 0, "bytes": 0}
    for block in _blocks(model).values():
        if block.tp is not None:
            out["all_reduces"] += block.tp.all_reduces
            out["bytes"] += block.tp.bytes
            if reset:
                block.tp.all_reduces = block.tp.bytes = 0
    return out


def attach(model: torch.nn.Module, model_mesh, shardings: dict) -> None:
    """Tell each CSWin block of ``model`` what this rank (coordinate
    ``model_mesh.rank`` of the model axis) holds of it under ``shardings``:
    its :class:`BlockShard`, and each branch its local heads and ``head0``.
    A group must be split whole or not at all; every block is checked
    before any is changed."""
    m, r = model_mesh.size, model_mesh.rank
    plan = []
    for bname, block in _blocks(model).items():
        names = {kind: f"{bname}.{kind}" for kind, _ in block.named_parameters()}
        groups = []
        for label, kinds in (("attention", [k for k in names if _is_attn(k)]),
                             ("MLP", [k for k in names if k in _MLP_KINDS])):
            state = {not shardings.get(names[k], REPLICATED).replicated for k in kinds}
            if len(state) > 1:
                raise ValueError(f"{bname}: its {label} group ({sorted(kinds)}) must be split "
                                 "whole or replicated whole")
            groups.append(state == {True})
        hidden = None
        if groups[1]:
            cols = shardings[names["mlp.fc1.weight"]].indices[r]
            hidden = (len(cols) * m, cols[0], cols[-1] + 1)
        plan.append((block, groups[0], hidden))
    for block, attn, hidden in plan:
        if attn:
            _, hb = _branch_heads(block)
            for branch in block.attns:
                branch.num_heads, branch.head0 = hb // m, r * (hb // m)
        block.tp = BlockShard(model_mesh, attn, hidden) if attn or hidden else None
