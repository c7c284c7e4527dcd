"""Training and evaluation steps and the epoch loop.

Counterpart of ``cswin_simam_unet_tpu/train/engine.py``: the optimizers
(AdamW, and Adam with L2-coupled weight decay), the training step for the
binary and the multi-class head with gradient accumulation and on-device
augmentation, the eval step, ``evaluate`` and ``fit`` with its plateau
schedule, 7-series history, checkpoints and TensorBoard logging.

The step takes uint8 images and masks.  The binary head trains on flat
logits: without augmentation its masks are unshuffled to the flat layout
while still uint8; with it, the order is JAX's: the batch is scaled to
[0, 1], augmented at image resolution (``data/augment.py``), its targets
finalised and only then unshuffled.  BCE, Dice and IoU (thresholded at 0 on
the logits: ``sigmoid(x) > 0.5`` exactly when ``x > 0``) are means over
pixels, which do not care about their order.  Several classes need the
class axis whole, so the multi-class step takes image-layout logits (the
kernels' flat logits pixel-shuffled), softmax cross-entropy and the
argmax's mean per-class Dice and IoU.  The training forward is
``train=True``: dropout, attention dropout and drop-path act at the model's
rates, with randomness from a host seed that the step hands down; the
augmentation's draws come from a stream of the same seed of their own
(:func:`augment_seed`), so dropout draws what it draws without them.  A
UNet's BatchNorm moves its running statistics in each training forward,
micro-batch after micro-batch (JAX's carry of ``batch_stats``), and the
eval step normalises with them.  The step and the eval step serve both
families through one forward signature, the CSWin-UNet's: ``model(images,
use_kernels=, flat_logits=, train=, rng=)``; the UNet takes the same
keywords, with nothing for ``use_kernels`` and ``rng`` to act on, and asks
for no flat logits (``supports_flat_logits`` False, see
:func:`_flat_head`).  The module's ``training`` flag is never set or read.
Metrics stay on the device: ``evaluate`` and ``fit`` fetch them once at the
end of a pass.

Data parallelism (``mesh``, a ``parallel.Mesh``): each rank takes its rows
of the global batch (``parallel.batch_sharding``), and the step makes what
JAX's partitioner would: after the last micro-batch one all-reduce a dtype
averages the gradients over the ranks, the loss is the global batch's mean
and Dice and IoU come from the summed counts; a UNet's BatchNorm sums its
moments over the ranks.  A batch that does not split evenly is computed
whole by every rank, and its gradients, loss and counts are averaged.
Augmentation draws the global (micro-)batch's parameters and each rank
applies its rows', so it equals one process; dropout, drop-path and the
attention masks come from a stream of each rank's own (:func:`rank_seed`),
whose rank 0 is the stream of a run without a mesh.  On a ``('data',
'model')`` mesh the rows and the streams are the data axis's: the model
ranks of one data coordinate take the same rows and draw from the same
stream.  A model that ``parallel.shard_state(..., params_shardings=)``
split runs its CSWin blocks tensor-parallel over the model axis
(``parallel/sharding.py``): the step averages each split parameter's
gradient over the data axis, and every other gradient, the loss and the
counts over the whole mesh (:func:`_reduce_step`).  A
``('spatial',)`` mesh, which shards an image's height
(``parallel.spatial_unet_apply``, ``parallel.spatial_cswin_apply``), is
refused, as JAX trains on none.  The
segmented step (``train/segmented.py``, ``FitConfig.segmented``) is this step
run as a chain of segments that may recompute their forwards in the backward,
which bounds the activation memory of the CSWin-UNet at 2048^2.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..data.augment import AugmentConfig, augment_batch
from ..data.pipeline import device_prefetch
from ..models.cswin import FLAT_HEAD_FACTOR
from ..ops.dropout import mix_seed
from ..ops.windows import pixel_unshuffle
from ..parallel.mesh import DATA_AXIS, batch_sharding, require_data_axis, shard_state
from .losses import segmentation_loss
from .reporting import EpochProgress, TensorBoardLogger
from .schedule import make_plateau_scheduler

METRICS = ("loss", "dice", "iou")
# the counter of the augmentation's stream of a step seed: the attention
# calls of a forward take the counters 1, 2, ... of the same seed
AUGMENT_STREAM = 0x41554721
# the counter of rank r's dropout stream of a step seed is RANK_STREAM + r
# (rank 0 keeps the step seed itself)
RANK_STREAM = 0x52414E4B


def make_optimizer(kind: str, learning_rate: float, weight_decay: float,
                   params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """The JAX package's two update rules: 'adamw' is torch AdamW (decoupled
    decay), ``optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay)``;
    'adam' is torch Adam with L2-coupled decay (``grad += wd * p`` before
    the moments), ``add_decayed_weights -> scale_by_adam -> scale(-lr)``."""
    if kind == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    if kind == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer: {kind}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def _to_device(x, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    if t.dtype != torch.uint8:
        raise TypeError(f"the training step takes uint8 images and masks, got {t.dtype}")
    return t.to(device, non_blocking=True)


def _flat_head(model: torch.nn.Module, n_classes: int) -> bool:
    """Train and evaluate on the flat (pre-pixel-shuffle) logits?  Only a
    model that has them (``supports_flat_logits``: the CSWin-UNet's head),
    and only with one class: softmax needs a whole class axis (flat lanes
    are ``s * classes + c``)."""
    return n_classes == 1 and getattr(model, "supports_flat_logits", False)


def _prepare_batch(images_u8: torch.Tensor, masks_u8: torch.Tensor, n_classes: int):
    """uint8 -> images in [0, 1]; binary masks / 255, class-id masks as float."""
    images = images_u8.float() / 255.0
    masks = masks_u8.float() / 255.0 if n_classes == 1 else masks_u8.float()
    return images, masks


def _finalize_targets(masks: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Binary: the masks.  Several classes: class ids (..., H, W) as int64,
    rounded and clipped to [0, n_classes - 1], so an out-of-range id (a
    0/255 mask given to a multi-class head) becomes the last class."""
    if n_classes == 1:
        return masks
    return masks[..., 0].round().clamp(0, n_classes - 1).long()


def _metric_sums(logits: torch.Tensor, targets: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Raw (intersection, |P|, |T|) sums, shape (3, n_classes), float32.
    Dice and IoU are ratios of global sums, so the sums of micro-batches add
    up to the full batch's.  Predictions: logits > 0 (one class), the argmax
    (several)."""
    if n_classes == 1:
        p = (logits.float() > 0.0).float().reshape(-1)
        t = targets.reshape(-1).float()
        return torch.stack([(p * t).sum(), p.sum(), t.sum()])[:, None]
    classes = torch.arange(n_classes, device=logits.device)
    p = logits.argmax(-1).unsqueeze(-1) == classes
    t = targets.unsqueeze(-1) == classes
    dims = tuple(range(p.ndim - 1))
    return torch.stack([(p & t).sum(dims), p.sum(dims), t.sum(dims)]).float()


def _metrics_from_sums(sums: torch.Tensor, smooth: float = 1e-6):
    """(mean per-class Dice, mean per-class IoU) from (3, C) sums; the same
    as ``dice_coefficient`` / ``iou_score`` (C = 1) and ``multiclass_metrics``."""
    inter, sp, st = sums[0], sums[1], sums[2]
    dice = ((2.0 * inter + smooth) / (sp + st + smooth)).mean()
    iou = ((inter + smooth) / (sp + st - inter + smooth)).mean()
    return dice, iou


def augment_seed(rng: int) -> int:
    """The seed of the augmentation's draws of one (micro-)batch, from the
    seed ``rng`` that its dropout uses."""
    return mix_seed(int(rng), AUGMENT_STREAM)


def rank_seed(rng: int, rank: int) -> int:
    """The seed of rank ``rank``'s dropout, drop-path and attention masks
    in a step of seed ``rng``: ``rng`` itself on rank 0, so that rank 0 of
    a mesh draws what a run without one draws."""
    return int(rng) if rank == 0 else mix_seed(int(rng), RANK_STREAM + rank)


def _inputs(model: torch.nn.Module, images_u8, masks_u8, n_classes: int,
            augment: Optional[AugmentConfig] = None, rng: Optional[int] = None,
            draw_rows: Optional[tuple] = None):
    """uint8 batch -> (images, targets) on the model's device: scale,
    augment from :func:`augment_seed` (``rng``) where ``augment`` is given,
    finalise the targets, then unshuffle the binary head's (JAX's order:
    the paired transform needs the masks at image resolution).
    ``draw_rows = (offset, n)``: the batch is rows [offset, offset + B) of
    a global batch of n, whose n draws are made and this batch's applied."""
    device = model.device
    images, masks = _prepare_batch(_to_device(images_u8, device),
                                   _to_device(masks_u8, device), n_classes)
    if augment is not None:
        if rng is None:
            raise ValueError("an augmented batch needs rng (an integer seed)")
        generator = torch.Generator(device=device)
        generator.manual_seed(augment_seed(rng))
        images, masks = augment_batch(generator, images, masks, augment, draw_rows)
    targets = _finalize_targets(masks, n_classes)
    if _flat_head(model, n_classes):
        return images, pixel_unshuffle(targets, FLAT_HEAD_FACTOR)
    return images, targets


def compute_gradients(model: torch.nn.Module, images_u8, masks_u8, n_classes: int = 1,
                      use_kernels: bool = True, rng=None, weight: float = 1.0,
                      augment: Optional[AugmentConfig] = None, rank: int = 0,
                      stats_mesh=None, draw_rows: Optional[tuple] = None):
    """Training forward (``train=True``, dropout randomness from the host
    seed ``rng``), loss and backward of ``weight`` x the loss on one uint8
    batch, augmented first where ``augment`` is given (draws from
    :func:`augment_seed` of ``rng``); the gradients are added to the
    parameters' ``.grad``.  Returns the loss, the logits (flat for the
    binary head, image layout for several classes) and the targets,
    detached.  On rank ``rank`` of a mesh the batch is that rank's rows
    ``draw_rows`` of the global batch (see :func:`_inputs`), its dropout
    draws from :func:`rank_seed`, and a UNet's BatchNorm sums its moments
    over ``stats_mesh``."""
    images, targets = _inputs(model, images_u8, masks_u8, n_classes, augment, rng, draw_rows)
    logits = model(images, use_kernels=use_kernels, flat_logits=_flat_head(model, n_classes),
                   train=True, rng=None if rng is None else rank_seed(rng, rank),
                   stats_mesh=stats_mesh)
    loss = segmentation_loss(logits, targets, n_classes)
    (loss * weight).backward()
    return loss.detach(), logits.detach(), targets


def micro_batches(batch: int, grad_accum: int) -> list:
    """(lo, hi, weight) of each micro-batch: ``grad_accum`` equal ones of
    weight 1/A when A divides the batch, else the first ``min(A, batch)``
    bounds of ``linspace(0, batch)``, each weighted by its share."""
    if batch % grad_accum == 0:
        m = batch // grad_accum
        return [(i * m, (i + 1) * m, 1.0 / grad_accum) for i in range(grad_accum)]
    bounds = np.linspace(0, batch, min(grad_accum, batch) + 1, dtype=np.int64)
    return [(int(lo), int(hi), (int(hi) - int(lo)) / batch)
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def _local_rows(sharding, images_u8, masks_u8, global_batch: Optional[int]):
    """(images, masks, global batch, split) of this rank: ``images_u8`` is
    the global batch, or (``global_batch`` given) this rank's rows of one
    already taken by ``sharding``; ``split`` whether the batch is split
    over the ranks (else every rank holds it whole)."""
    if sharding is None:
        return images_u8, masks_u8, images_u8.shape[0], False
    if global_batch is None:
        global_batch = images_u8.shape[0]
        rows = sharding.rows(global_batch)
        if len(rows) < global_batch:
            images_u8, masks_u8 = images_u8[rows], masks_u8[rows]
    elif images_u8.shape[0] != len(sharding.rows(global_batch)):
        raise ValueError(f"{images_u8.shape[0]} rows are not this rank's share of a global "
                         f"batch of {global_batch}")
    return images_u8, masks_u8, int(global_batch), sharding.splits(global_batch)


def _mean_over(mesh, grads: list, stats: Optional[torch.Tensor] = None):
    """One all-reduce a dtype over the ranks of ``mesh``: ``grads`` averaged
    in place; ``stats`` (float32) travels in the float32 buffer and comes
    back summed."""
    n = mesh.size
    groups: dict = {torch.float32: []}
    for g in grads:
        groups.setdefault(g.dtype, []).append(g)
    for dtype, group in groups.items():
        extra = [stats] if dtype == torch.float32 and stats is not None else []
        if not group and not extra:
            continue
        flat = mesh.all_reduce_(torch.cat([g.reshape(-1) for g in group] + extra))
        offset = 0
        for g in group:
            g.copy_(flat[offset:offset + g.numel()].view_as(g)).div_(n)
            offset += g.numel()
        if extra:
            stats = flat[offset:]
    return stats


def _reduce_over_ranks(mesh, grads: list, loss: torch.Tensor, sums: torch.Tensor,
                       split: bool, copies: int = 1):
    """One all-reduce a dtype over the ranks: the gradients (``grads``, in
    place) and the loss averaged; the metric counts summed for a split
    batch (and divided by ``copies``, the ranks of ``mesh`` that hold each
    row: the model ranks of a ``('data', 'model')`` mesh), averaged for one
    that every rank computed whole.  The loss and counts travel in the
    float32 buffer."""
    n = mesh.size
    stats = _mean_over(mesh, grads, torch.cat([loss.detach().float().reshape(1),
                                              sums.detach().float().reshape(-1)]))
    return stats[0] / n, stats[1:].reshape(sums.shape) / (copies if split else n)


def _reduce_step(model, mesh, data, loss, sums, split: bool):
    """The step's reduction over a mesh: the gradients of the parameters
    split over the model axis (``parallel.shard_state``'s shards) averaged
    over the data axis, every other gradient, the loss and the counts over
    the whole mesh.  The model ranks of a data coordinate hold equal
    replicated gradients but for the last bits of nondeterministic kernels
    (cuDNN's convolution backward), which their mean removes, so that the
    replicated parameters stay bit-identical over the model group."""
    split_names = getattr(model, "tp_shardings", None) or {}
    grads = [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]
    if split_names:
        _mean_over(data, [g for n, g in grads if n in split_names])
    return _reduce_over_ranks(mesh, [g for n, g in grads if n not in split_names], loss, sums,
                              split, mesh.size // data.size)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    n_classes: int = 1, use_kernels: bool = True,
                    augment: Optional[AugmentConfig] = None, grad_accum: int = 1,
                    seed: int = 0, mesh=None) -> Callable:
    """The step ``(images_u8 (B, H, W, C), masks_u8 (B, H, W, 1), rng=None)
    -> {'loss', 'dice', 'iou'}`` (0-d float32 tensors on the model's device;
    reading them synchronises).  One optimizer step per call.

    ``rng`` is the step's host seed; without it call k of the step uses
    ``mix_seed(seed, k)``.  With ``grad_accum = A > 1`` the batch is split
    into micro-batches (:func:`micro_batches`), micro-batch i trains with
    the seed ``mix_seed(rng, i)``, and each one's loss is weighted by its
    share before its backward, so ``.grad`` holds the full batch's mean
    gradient; the loss is summed with the same weights and Dice and IoU come
    from the micro-batches' summed counts, equal to the full batch's.  With
    ``augment`` each micro-batch is augmented on the device from its own
    seed's augmentation stream (JAX folds the micro-batch index into its
    augmentation key the same way); class-id masks need
    ``augment.mask_nearest``.

    With ``mesh`` (a ``parallel.Mesh``) the step is one step of the global
    batch over the ranks (see the module's docstring): every rank calls it
    with the same ``rng``, and with the global batch, or with its rows of
    one (``global_batch=`` the global batch's size, the rows that
    ``parallel.batch_sharding(mesh, grad_accum=A)`` gives this rank).  The
    returned metrics and ``.grad`` are the global batch's on every rank."""
    def gradients(images_u8, masks_u8, rng, weight, rank, stats_mesh, draw_rows):
        return compute_gradients(model, images_u8, masks_u8, n_classes, use_kernels, rng,
                                 weight, augment, rank, stats_mesh, draw_rows)

    return _make_step(model, optimizer, n_classes, augment, grad_accum, seed, mesh, gradients)


def _make_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, n_classes: int,
               augment: Optional[AugmentConfig], grad_accum: int, seed: int, mesh,
               gradients: Callable) -> Callable:
    """The step of :func:`make_train_step` over ``model`` around ``gradients(images_u8,
    masks_u8, rng, weight, rank, stats_mesh, draw_rows) -> (loss, logits,
    targets)``, which adds ``weight`` x one micro-batch's gradients to the
    parameters' ``.grad`` as :func:`compute_gradients` does: the seeds, the
    micro-batches, this rank's rows, the reduction over the ranks and the
    optimizer's step."""
    if mesh is not None:
        require_data_axis(mesh)
    accum = int(grad_accum)
    if accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if n_classes > 1 and augment is not None and not augment.mask_nearest:
        raise ValueError("class-id masks need augment.mask_nearest=True: bilinear "
                         "resampling blends neighbouring class ids")
    sharding = batch_sharding(mesh, grad_accum=accum) if mesh is not None else None
    data = sharding.mesh if sharding is not None else None
    rank = data.rank if data is not None else 0
    calls = [0]

    def step(images_u8, masks_u8, rng: Optional[int] = None,
             global_batch: Optional[int] = None) -> dict:
        if rng is None:
            rng = mix_seed(seed, calls[0])
            calls[0] += 1
        images_u8, masks_u8, n_global, split = _local_rows(sharding, images_u8, masks_u8,
                                                           global_batch)
        stats_mesh = data if split else None
        optimizer.zero_grad(set_to_none=True)
        loss, sums = 0.0, 0.0
        for i, (lo, hi, w) in enumerate(micro_batches(images_u8.shape[0], accum)):
            # rows [lo, hi) of this rank are its share of global micro-batch i
            draw_rows = (rank * (hi - lo), n_global // accum) if split else None
            mloss, logits, targets = gradients(
                images_u8[lo:hi], masks_u8[lo:hi], rng if accum == 1 else mix_seed(rng, i),
                w, rank, stats_mesh, draw_rows)
            loss = loss + w * mloss
            sums = sums + _metric_sums(logits, targets, n_classes)
        if data is not None:
            loss, sums = _reduce_step(model, mesh, data, loss, sums, split)
        optimizer.step()
        dice, iou = _metrics_from_sums(sums)
        return {"loss": loss, "dice": dice, "iou": iou}

    return step


def make_eval_step(model: torch.nn.Module, n_classes: int = 1, mesh=None) -> Callable:
    """The eval step ``(images_u8, masks_u8) -> {'loss', 'dice', 'iou'}``:
    an eval forward (``train=False``, no dropout) on the kernels under
    ``no_grad``.  With ``mesh`` each rank evaluates its rows, taken as the
    training step takes them (``global_batch=`` likewise), and the metrics
    are the global batch's on every rank."""
    if mesh is not None:
        require_data_axis(mesh)
    sharding = batch_sharding(mesh) if mesh is not None else None

    @torch.no_grad()
    def step(images_u8, masks_u8, global_batch: Optional[int] = None) -> dict:
        images_u8, masks_u8, _, split = _local_rows(sharding, images_u8, masks_u8,
                                                    global_batch)
        images, targets = _inputs(model, images_u8, masks_u8, n_classes)
        logits = model(images, flat_logits=_flat_head(model, n_classes), train=False)
        loss = segmentation_loss(logits, targets, n_classes)
        sums = _metric_sums(logits, targets, n_classes)
        if mesh is not None:
            loss, sums = _reduce_over_ranks(mesh, [], loss, sums, split,
                                            mesh.size // mesh.along(DATA_AXIS).size)
        dice, iou = _metrics_from_sums(sums)
        return {"loss": loss, "dice": dice, "iou": iou}

    return step


def _fetch_means(per_batch: list) -> Dict[str, float]:
    """The uniform mean over batches of each metric, fetched in one copy;
    NaN for no batch."""
    if not per_batch:
        return {k: float("nan") for k in METRICS}
    fetched = torch.stack([torch.stack([m[k] for k in METRICS]) for m in per_batch]).cpu()
    means = np.mean(fetched.numpy(), axis=0)
    return {k: float(v) for k, v in zip(METRICS, means)}


def evaluate(eval_step: Callable, loader, device, sharding=None) -> Dict[str, float]:
    """Metrics over a whole loader, averaged uniformly over batches (the
    reference's weighting, partial last batch included).  Each batch's
    scalars stay on the device; one copy fetches them all at the end.  With
    ``sharding`` (the eval step's mesh's ``batch_sharding``) each rank
    moves and evaluates its rows only."""
    per_batch = [eval_step(*batch) for batch in device_prefetch(loader, device,
                                                                sharding=sharding)]
    return _fetch_means(per_batch)


@dataclass
class FitConfig:
    """``fit``'s settings, the JAX package's ``FitConfig``: it augments by
    default, as JAX's does.  ``segmented`` trains a CSWin-UNet with the
    segmented step (``train/segmented.py``, its residual policy "auto"),
    whose stages deeper than ``seg_depth_split`` blocks are cut into chunks
    of that many (0: one segment per stage)."""
    num_epochs: int = 100
    n_classes: int = 1
    augment: Optional[AugmentConfig] = AugmentConfig()
    plateau_factor: float = 0.5
    plateau_patience: int = 5
    plateau_min_lr: float = 1e-7
    grad_accum: int = 1
    segmented: bool = False
    seg_depth_split: int = 0
    seed: int = 42
    log_every: int = 0  # batches; 0 = epoch lines only
    progress: bool = True
    checkpoint_manager: Any = None  # train.checkpoint.CheckpointStore
    # checkpoint period in epochs (0: the last epoch only); the last epoch
    # is always saved
    checkpoint_every: int = 1
    tensorboard_dir: Optional[str] = None
    verbose: bool = True


def empty_history() -> Dict[str, list]:
    return {k: [] for k in ("train_loss", "train_dice", "train_iou", "test_loss",
                            "test_dice", "test_iou", "learning_rates")}


def fit(model: torch.nn.Module, optimizer: torch.optim.Optimizer, train_loader, test_loader,
        cfg: FitConfig, history: Optional[Dict[str, list]] = None, scheduler=None,
        start_epoch: int = 0, global_step: int = 0, mesh=None):
    """The epoch loop: a training pass, a full test pass, the plateau
    schedule stepped on the test loss, and the 7-series history.  Returns
    ``(history, global_step)``; ``model`` and ``optimizer`` are trained in
    place.

    Loaders yield (images_u8, masks_u8) batches, host arrays or tensors;
    they reach the device through :func:`device_prefetch`.  Each training
    batch's scalars stay on the device and are fetched once an epoch; only
    the progress line (the previous batch, at a bounded rate) and
    ``log_every`` read them sooner.  Step k of epoch e trains with the seed
    ``mix_seed(cfg.seed, e * 1_000_000 + k)``, k counted over the whole run
    (its augmentation draws come from the same seed's own stream), so a run
    resumed with ``start_epoch``, ``global_step``, ``history`` and
    ``scheduler`` (and the model's and optimizer's states, as
    ``CheckpointStore.restore`` gives them back) follows the trajectory of
    the run that was not stopped.  With ``cfg.checkpoint_manager`` the
    epochs that ``checkpoint_every`` names, and the last, are saved; with
    ``cfg.tensorboard_dir`` each epoch's metrics are logged there.

    With ``mesh`` (a ``parallel.Mesh``, ``('data',)`` or ``('data',
    'model')``; every rank calls ``fit`` with the same loaders, or with
    loaders sharded by ``parallel.batch_sharding``) the state is replicated
    from rank 0 over every axis (``shard_state`` without
    ``params_shardings``, as JAX's ``fit`` places it), each rank moves and
    trains on its rows of every batch (the data axis's split), and the
    histories, the schedule and the learning rates are the same on every
    rank.  Rank 0 alone
    prints, writes the checkpoints and logs to TensorBoard; every rank
    waits for each checkpoint."""
    device = model.device
    train_sharding = eval_sharding = None
    main = mesh is None or mesh.is_main
    if mesh is not None:
        require_data_axis(mesh)
        if mesh.device != device:
            raise ValueError(f"the mesh's device {mesh.device} is not the model's {device}")
        shard_state(model, optimizer, mesh)
        train_sharding = batch_sharding(mesh, grad_accum=cfg.grad_accum)
        eval_sharding = batch_sharding(mesh)
    verbose = cfg.verbose and main
    if cfg.segmented:
        from .segmented import make_segmented_train_step
        train_step = make_segmented_train_step(
            model, optimizer, cfg.n_classes, augment=cfg.augment, grad_accum=cfg.grad_accum,
            mesh=mesh, depth_split=cfg.seg_depth_split)
        eval_step = train_step.eval_step
    else:
        train_step = make_train_step(model, optimizer, cfg.n_classes, augment=cfg.augment,
                                     grad_accum=cfg.grad_accum, mesh=mesh)
        eval_step = make_eval_step(model, cfg.n_classes, mesh=mesh)
    if scheduler is None:
        scheduler = make_plateau_scheduler(optimizer, cfg.plateau_factor,
                                           cfg.plateau_patience, cfg.plateau_min_lr)
    history = history if history is not None else empty_history()
    tb = TensorBoardLogger(cfg.tensorboard_dir) if cfg.tensorboard_dir and main else None

    for epoch in range(start_epoch, cfg.num_epochs):
        t0 = time.time()
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        per_batch, n_images, progress = [], 0, None
        if verbose and cfg.progress:
            total = len(train_loader) if hasattr(train_loader, "__len__") else None
            progress = EpochProgress(epoch, cfg.num_epochs, total)
        for images, masks, *share in device_prefetch(train_loader, device,
                                                     sharding=train_sharding):
            global_batch = share[0] if share else None
            m = train_step(images, masks, rng=mix_seed(cfg.seed, epoch * 1_000_000 + global_step),
                           global_batch=global_batch)
            per_batch.append(m)
            batch_images = global_batch or images.shape[0]
            n_images += batch_images
            global_step += 1
            if progress is not None and len(per_batch) > 1:
                # the previous batch's scalars: that batch is done, so reading
                # them does not wait on the step just enqueued
                progress.update(len(per_batch) - 1, n_images - batch_images, per_batch[-2])
            if verbose and cfg.log_every and len(per_batch) % cfg.log_every == 0:
                live = {k: float(v) for k, v in per_batch[-1].items()}
                print(f"  epoch {epoch + 1} batch {len(per_batch)}: "
                      f"loss {live['loss']:.4f} dice {live['dice']:.4f} iou {live['iou']:.4f}")
        if progress is not None:
            progress.close()
        train_metrics = _fetch_means(per_batch)
        test_metrics = evaluate(eval_step, test_loader, device, eval_sharding)
        # torch's scheduler sets the optimizer's learning rate itself
        scheduler.step(test_metrics["loss"])
        lr = get_learning_rate(optimizer)

        for split, metrics in (("train", train_metrics), ("test", test_metrics)):
            for k in METRICS:
                history[f"{split}_{k}"].append(metrics[k])
        history["learning_rates"].append(lr)
        if tb is not None:
            tb.log_epoch(epoch + 1, train_metrics, test_metrics, lr)

        dt = time.time() - t0
        if verbose:
            print(f"Epoch [{epoch + 1}/{cfg.num_epochs}]  "
                  f"({dt:.1f}s, {n_images / max(dt, 1e-9):.1f} img/s)")
            print(f"  Train - Loss: {train_metrics['loss']:.4f}, "
                  f"Dice: {train_metrics['dice']:.4f}, IoU: {train_metrics['iou']:.4f}")
            print(f"  Test  - Loss: {test_metrics['loss']:.4f}, "
                  f"Dice: {test_metrics['dice']:.4f}, IoU: {test_metrics['iou']:.4f}")
            print(f"  LR: {lr:.8f}")

        is_last = epoch + 1 == cfg.num_epochs
        due = cfg.checkpoint_every and (epoch + 1) % cfg.checkpoint_every == 0
        if cfg.checkpoint_manager is not None and (due or is_last):
            if main:
                cfg.checkpoint_manager.save_epoch(epoch + 1, model, optimizer, scheduler,
                                                  history, test_dice=test_metrics["dice"],
                                                  global_step=global_step)
            if mesh is not None:
                mesh.barrier()
    if tb is not None:
        tb.close()
    return history, global_step
