"""Segmented training step: activation memory bounded by recomputing segments.

Counterpart of ``cswin_simam_unet_tpu/train/segmented.py``.  The
CSWin-UNet's forward is cut into segments that hand a carry of tokens (and
skips) from one to the next::

    embed       stage1_conv_embed                     x -> tokens
    enc{s}      stage{s}, merge{s}                    tokens -> tokens, skip{s-1}
    bottleneck  stage4, norm, stage_up4               tokens -> tokens
    dec{s}      upsample{s+1}, concat_linear{s+1},
                stage_up{s}                           tokens, skip{s-1} -> tokens
    head        norm_up, upsample1, output            tokens -> logits

With ``depth_split = d > 0`` every stage deeper than d blocks is cut into
chunks of at most d blocks (``enc3x0``, ``enc3x1``, ..., ``dec3x0``, ...):
an encoder's last chunk emits the skip and runs the merge, a decoder's first
chunk takes the skip and runs the CARAFE up and the fusion.  A skip goes
from the segment that makes it straight to the one that reads it.  The
segments run the model's own modules (``CSWinUNet.embed``, ``run_blocks``,
``merge``, ``fuse_skip``, ``head``), so their chain computes what
``CSWinUNet.forward`` computes, kernels and flat logits included, with the
same parameters and drop-path schedule.

A segment either keeps its autograd graph ("save") or runs under
``torch.no_grad`` keeping only its input carry ("recompute"), and then runs
its forward again with the graph in the backward.  The backward walks the
segments in reverse: each back-propagates the cotangents of its outputs,
the parameters' gradients collect in ``.grad`` and the cotangents of its
inputs go to the segments that made them.  Activation memory is then the
saved segments' residuals plus one recomputed segment's.

Dropout, attention dropout and drop-path draw from the forward's
``DropoutRng``: its explicit generator and its count of attention calls are
taken at each segment's start and put back before the segment's recompute,
so a segmented step draws what the monolithic step draws from the same
seed, under any policy (JAX draws a stream of its own for each segment).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..data.augment import AugmentConfig
from ..models.cswin import CSWinUNet
from .engine import _flat_head, _inputs, _make_step, make_eval_step, rank_seed
from .losses import segmentation_loss

NO_CARD_MEMORY = 16 * 1024 ** 3  # the residual budget's memory without a card, as in JAX


@dataclass(frozen=True)
class Segment:
    """One segment: the carry keys it takes (``ins``) and gives (``outs``),
    the modules it runs (``modules``: state_dict prefixes, which own their
    parameters) and ``run(carry, use_kernels, rng) -> carry``."""
    name: str
    ins: Tuple[str, ...]
    outs: Tuple[str, ...]
    modules: Tuple[str, ...]
    run: Callable


def _chunks(depth: int, depth_split: int) -> List[Tuple[int, int]]:
    """The [lo, hi) block ranges of a stage of ``depth`` blocks."""
    if not depth_split or depth <= depth_split:
        return [(0, depth)]
    bounds = list(range(0, depth, depth_split)) + [depth]
    return list(zip(bounds[:-1], bounds[1:]))


def build_segments(model: CSWinUNet, flat_logits: bool = False,
                   depth_split: int = 0) -> List[Segment]:
    """The model's segments in forward order (see the module's docstring);
    the head gives flat logits where ``flat_logits``.  Each call builds its
    own segments: nothing is registered outside them."""
    if not isinstance(model, CSWinUNet):
        raise ValueError("--segmented supports the CSWin family only "
                         f"(got {type(model).__name__}); UNet's monolithic graph "
                         "compiles fine at any size it fits in memory")
    if depth_split < 0:
        raise ValueError(f"depth_split must be >= 0 (0: one segment per stage), "
                         f"got {depth_split}")
    m = model

    def embed(c, k, rng):
        return {"tokens": m.embed(c["x"], rng)}

    def encoder(s, lo, hi, tail):
        def run(c, k, rng):
            tokens = m.run_blocks(f"stage{s + 1}", c["tokens"], k, rng, lo, hi)
            if not tail:
                return {"tokens": tokens}
            return {"tokens": m.merge(s, tokens), f"skip{s}": tokens}
        return run

    def bottleneck(c, k, rng):
        tokens = m.run_blocks("stage4", c["tokens"], k, rng)
        return {"tokens": m.run_blocks("stage_up4", m.norm(tokens), k, rng)}

    def decoder(s, lo, hi, entry):
        def run(c, k, rng):
            tokens = m.fuse_skip(s, c["tokens"], c[f"skip{s}"], k) if entry else c["tokens"]
            return {"tokens": m.run_blocks(f"stage_up{s + 1}", tokens, k, rng, lo, hi)}
        return run

    def head(c, k, rng):
        return {"tokens": m.head(m.norm_up(c["tokens"]), k, flat_logits)}

    segs = [Segment("embed", ("x",), ("tokens",), ("stage1_conv_embed",), embed)]
    for s in range(3):
        stage = f"stage{s + 1}"
        ck = _chunks(m.depth[s], depth_split)
        for j, (lo, hi) in enumerate(ck):
            tail = hi == m.depth[s]
            blocks = (stage,) if len(ck) == 1 else tuple(f"{stage}.{i}" for i in range(lo, hi))
            segs.append(Segment(
                f"enc{s + 1}" if len(ck) == 1 else f"enc{s + 1}x{j}", ("tokens",),
                ("tokens", f"skip{s}") if tail else ("tokens",),
                blocks + ((f"merge{s + 1}",) if tail else ()), encoder(s, lo, hi, tail)))
    segs.append(Segment("bottleneck", ("tokens",), ("tokens",),
                        ("stage4", "norm", "stage_up4"), bottleneck))
    for s in (2, 1, 0):
        stage = f"stage_up{s + 1}"
        ck = _chunks(m.depth[s], depth_split)
        for j, (lo, hi) in enumerate(ck):
            entry = lo == 0
            blocks = (stage,) if len(ck) == 1 else tuple(f"{stage}.{i}" for i in range(lo, hi))
            segs.append(Segment(
                f"dec{s + 1}" if len(ck) == 1 else f"dec{s + 1}x{j}",
                ("tokens", f"skip{s}") if entry else ("tokens",), ("tokens",),
                ((f"upsample{s + 2}", f"concat_linear{s + 2}") if entry else ()) + blocks,
                decoder(s, lo, hi, entry)))
    segs.append(Segment("head", ("tokens",), ("tokens",), ("norm_up", "upsample1", "output"),
                        head))
    return segs


def segment_param_keys(model: torch.nn.Module, segments: List[Segment]) -> List[List[str]]:
    """The model's parameter names (state_dict names) owned by each segment:
    those of the modules it runs.  A parameter that no segment owns, or
    that two own, is an error."""
    owners: Dict[str, List[str]] = {}
    out = []
    for seg in segments:
        keys = sorted(n for n, _ in model.named_parameters()
                      if any(n.startswith(p + ".") for p in seg.modules))
        for k in keys:
            owners.setdefault(k, []).append(seg.name)
        out.append(keys)
    missing = sorted(n for n, _ in model.named_parameters() if n not in owners)
    if missing:
        raise ValueError(f"unassigned params: {missing}")
    doubled = {k: v for k, v in owners.items() if len(v) > 1}
    if doubled:
        raise ValueError(f"params owned by several segments: {doubled}")
    return out


def _leaves(carry: dict) -> dict:
    """The carry as leaves of a new graph: the tokens and skips ask for
    their gradients, the images (``x``) do not."""
    return {k: v.detach().requires_grad_(k != "x") for k, v in carry.items()}


def _card_budget(model: torch.nn.Module, mesh) -> int:
    """The residual budget: 0.7 x the memory this rank may use (its card's,
    split over the ranks that share the card; 16 GiB without a card) less
    5 x the parameters' bytes (the weights, the optimizer's two moments, the
    gradients and the update's temporaries)."""
    dev = model.device
    if dev.type == "cuda":
        memory = torch.cuda.get_device_properties(dev).total_memory
        if mesh is not None:
            cards = torch.cuda.device_count()
            memory //= sum(1 for r in range(mesh.size) if r % cards == mesh.rank % cards)
    else:
        memory = NO_CARD_MEMORY
    p_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    return int(0.7 * memory) - 5 * p_bytes


def _policy_of(save_residuals, names: List[str]) -> Optional[List[bool]]:
    """The per-segment policy (True: save) of ``save_residuals``; None for
    "auto", which the first call resolves."""
    if save_residuals == "auto":
        return None
    if isinstance(save_residuals, bool):
        return [save_residuals] * len(names)
    if isinstance(save_residuals, (set, frozenset, list, tuple)):
        unknown = set(save_residuals) - set(names)
        if unknown:
            raise ValueError(f"save_residuals names not segments: {sorted(unknown)} "
                             f"(have {names})")
        return [n in set(save_residuals) for n in names]
    raise ValueError(f"save_residuals: bool, 'auto', or a collection of segment names "
                     f"(got {save_residuals!r})")


def make_segmented_train_step(model: CSWinUNet, optimizer: torch.optim.Optimizer,
                              n_classes: int = 1, use_kernels: bool = True,
                              augment: Optional[AugmentConfig] = None, grad_accum: int = 1,
                              seed: int = 0, mesh=None, save_residuals="auto",
                              residual_budget_bytes: Optional[int] = None,
                              depth_split: int = 0) -> Callable:
    """The training step of ``engine.make_train_step``, with its call
    ``(images_u8, masks_u8, rng=None, global_batch=None) -> {'loss', 'dice',
    'iou'}``, its seeds, micro-batches, augmentation and ``mesh``, run as a
    chain of segments (see the module's docstring).  ``grad_accum`` needs a
    batch that it divides, as in JAX.  Under a ``data`` mesh each rank runs
    the chain on its rows, and one all-reduce averages the gradients.

    ``save_residuals``: True (every segment keeps its graph), False (every
    segment recomputes), a collection of segment names (those save, the rest
    recompute) or ``"auto"``: on the first call each segment's residuals are
    sized from the real shapes (one forward of each segment in turn, whose
    saved tensors' unique storages are counted, parameters aside, and then
    freed), and the largest segments recompute until the rest fit
    ``residual_budget_bytes`` (default: 0.7 x the card's memory, split over
    the ranks that share it, less 5 x the parameters' bytes; 16 GiB without
    a card).  An explicit policy holds under a mesh too.  ``depth_split``
    cuts deep stages into chunks (:func:`build_segments`).

    ``step.residual_policy()`` gives {segment: saves?}, None until "auto"
    is resolved.  ``step.eval_step`` is ``engine.make_eval_step``'s: a
    forward without gradients keeps no residuals, so it needs no segments.
    JAX's ``cost_flops`` (XLA's cost analysis) has no eager counterpart.
    A mesh with a ``model`` axis is refused: JAX's segmented step takes a
    ``('data',)`` mesh (its ``train/segmented.py:409``)."""
    if mesh is not None and "model" in mesh.axis_names:
        raise ValueError(f"the segmented step takes a ('data',) mesh, as JAX's does; got a "
                         f"mesh over {tuple(mesh.axis_names)}")
    segments = build_segments(model, _flat_head(model, n_classes), depth_split)
    names = [seg.name for seg in segments]
    policy = _policy_of(save_residuals, names)
    accum = int(grad_accum)

    def resolve(images: torch.Tensor) -> List[bool]:
        params = {p.untyped_storage().data_ptr() for p in model.parameters()}
        drng = model.dropout_rng(True, 0)
        sizes, carry = [], {"x": images}
        for seg in segments:
            saved: Dict[int, int] = {}

            def pack(t):
                storage = t.untyped_storage()
                if storage.data_ptr() not in params:
                    saved[storage.data_ptr()] = storage.nbytes()
                # detached: a saved output returned whole would hold its own
                # graph in a cycle that is never freed
                return t.detach()

            with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                    pack, lambda t: t):
                out = seg.run(_leaves({k: carry.pop(k) for k in seg.ins}), use_kernels, drng)
            sizes.append(sum(saved.values()))
            carry.update({k: v.detach() for k, v in out.items()})
            del out
        budget = (residual_budget_bytes if residual_budget_bytes is not None
                  else _card_budget(model, mesh))
        mode, total = [True] * len(segments), sum(sizes)
        for i in sorted(range(len(segments)), key=lambda i: -sizes[i]):
            if total <= budget:
                break
            mode[i] = False
            total -= sizes[i]
        if mesh is None or mesh.is_main:
            print(f"segmented: auto residual policy — save "
                  f"{[n for n, s in zip(names, mode) if s]}, recompute "
                  f"{[n for n, s in zip(names, mode) if not s]} "
                  f"(residuals {sum(sizes) / 1e9:.2f} GB total, {total / 1e9:.2f} GB kept, "
                  f"budget {budget / 1e9:.2f} GB)", file=sys.stderr)
        return mode

    def gradients(images_u8, masks_u8, rng, weight, rank, stats_mesh, draw_rows):
        nonlocal policy
        images, targets = _inputs(model, images_u8, masks_u8, n_classes, augment, rng, draw_rows)
        if policy is None:
            policy = resolve(images)
        drng = model.dropout_rng(True, None if rng is None else rank_seed(rng, rank))
        # forward: a saved segment keeps (its input leaves, its outputs), a
        # recomputed one (its inputs, where the draws stood at its start)
        carry, kept = {"x": images}, []
        for seg, save in zip(segments, policy):
            cin = {k: carry.pop(k) for k in seg.ins}
            if save:
                cin = _leaves(cin)
                with torch.enable_grad():
                    out = seg.run(cin, use_kernels, drng)
                kept.append((cin, out, None))
                carry.update({k: v.detach() for k, v in out.items()})
            else:
                start = None if drng is None else drng.state()
                with torch.no_grad():
                    out = seg.run(cin, use_kernels, drng)
                kept.append((cin, None, start))
                carry.update(out)
        logits = carry.pop("tokens").detach().requires_grad_()
        with torch.enable_grad():
            loss = segmentation_loss(logits, targets, n_classes)
            (loss * weight).backward()
        # backward, segment by segment in reverse
        cot = {"tokens": logits.grad}
        for i in reversed(range(len(segments))):
            seg, (cin, out, start) = segments[i], kept[i]
            kept[i] = None
            if out is None:
                if drng is not None:
                    drng.restore(start)
                cin = _leaves(cin)
                with torch.enable_grad():
                    out = seg.run(cin, use_kernels, drng)
            torch.autograd.backward([out[k] for k in seg.outs], [cot.pop(k) for k in seg.outs])
            del out
            cot.update({k: v.grad for k, v in cin.items() if v.requires_grad})
        return loss.detach(), logits.detach(), targets

    chain = _make_step(model, optimizer, n_classes, augment, accum, seed, mesh, gradients)

    def step(images_u8, masks_u8, rng: Optional[int] = None,
             global_batch: Optional[int] = None) -> dict:
        batch = images_u8.shape[0] if global_batch is None else int(global_batch)
        if batch % accum:
            raise ValueError(f"segmented grad_accum needs batch % accum == 0 "
                             f"(got {batch} % {accum})")
        return chain(images_u8, masks_u8, rng, global_batch)

    step.residual_policy = lambda: None if policy is None else dict(zip(names, policy))
    step.eval_step = make_eval_step(model, n_classes, mesh=mesh)
    return step
