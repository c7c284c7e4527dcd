"""Training and evaluation steps and the epoch loop.

Counterpart of ``cswin_simam_unet_tpu/train/engine.py``: the optimizers
(AdamW, and Adam with L2-coupled weight decay), the training step for the
binary and the multi-class head with gradient accumulation, the eval step,
``evaluate`` and ``fit`` with its plateau schedule and 7-series history.

The step takes uint8 images and masks.  The binary head trains on flat
logits: its masks are unshuffled to the flat layout while still uint8, and
BCE, Dice and IoU (thresholded at 0 on the logits: ``sigmoid(x) > 0.5``
exactly when ``x > 0``) are means over pixels, which do not care about
their order.  Several classes need the class axis whole, so the
multi-class step takes image-layout logits (the kernels' flat logits
pixel-shuffled), softmax cross-entropy and the argmax's mean per-class Dice
and IoU.  The training forward is ``train=True``: dropout, attention
dropout and drop-path act at the model's rates, with randomness from a host
seed that the step hands down; the module's ``training`` flag is never set
or read.  Metrics stay on the device: ``evaluate`` and ``fit`` fetch them
once at the end of a pass.  Augmentation (ROADMAP queue A item 5),
checkpoints and TensorBoard (item 6), data parallelism (item 9) and the
segmented step (item 10) are not ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..data.pipeline import device_prefetch
from ..models.cswin import FLAT_HEAD_FACTOR
from ..ops.dropout import mix_seed
from ..ops.windows import pixel_unshuffle
from .losses import segmentation_loss
from .reporting import EpochProgress
from .schedule import make_plateau_scheduler

METRICS = ("loss", "dice", "iou")


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


def _flat_head(n_classes: int) -> bool:
    """Train and evaluate on the flat (pre-pixel-shuffle) logits?  Only the
    binary head: softmax needs a whole class axis (flat lanes are
    ``s * classes + c``)."""
    return n_classes == 1


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


def _batch_metrics(logits: torch.Tensor, targets: torch.Tensor, n_classes: int):
    return _metrics_from_sums(_metric_sums(logits, targets, n_classes))


def _inputs(model: torch.nn.Module, images_u8, masks_u8, n_classes: int):
    """uint8 batch -> (images, targets) on the model's device, the binary
    head's masks unshuffled while uint8 (the same values, a quarter of the
    bytes)."""
    device = model.device
    images_u8, masks_u8 = _to_device(images_u8, device), _to_device(masks_u8, device)
    if _flat_head(n_classes):
        masks_u8 = pixel_unshuffle(masks_u8, FLAT_HEAD_FACTOR)
    images, masks = _prepare_batch(images_u8, masks_u8, n_classes)
    return images, _finalize_targets(masks, n_classes)


def compute_gradients(model: torch.nn.Module, images_u8, masks_u8, n_classes: int = 1,
                      use_kernels: bool = True, rng=None, weight: float = 1.0):
    """Training forward (``train=True``, dropout randomness from the host
    seed ``rng``), loss and backward of ``weight`` x the loss on one uint8
    batch; the gradients are added to the parameters' ``.grad``.  Returns
    the loss, the logits (flat for the binary head, image layout for
    several classes) and the targets, detached."""
    images, targets = _inputs(model, images_u8, masks_u8, n_classes)
    logits = model(images, use_kernels=use_kernels, flat_logits=_flat_head(n_classes),
                   train=True, rng=rng)
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


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    n_classes: int = 1, use_kernels: bool = True,
                    augment=None, grad_accum: int = 1, seed: int = 0) -> Callable:
    """The step ``(images_u8 (B, H, W, C), masks_u8 (B, H, W, 1), rng=None)
    -> {'loss', 'dice', 'iou'}`` (0-d float32 tensors on the model's device;
    reading them synchronises).  One optimizer step per call.

    ``rng`` is the step's host seed; without it call k of the step uses
    ``mix_seed(seed, k)``.  With ``grad_accum = A > 1`` the batch is split
    into micro-batches (:func:`micro_batches`), micro-batch i trains with
    the seed ``mix_seed(rng, i)``, and each one's loss is weighted by its
    share before its backward, so ``.grad`` holds the full batch's mean
    gradient; the loss is summed with the same weights and Dice and IoU come
    from the micro-batches' summed counts, equal to the full batch's."""
    if augment is not None:
        raise NotImplementedError("on-device augmentation is not ported yet "
                                  "(ROADMAP queue A item 5)")
    accum = int(grad_accum)
    if accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    calls = [0]

    def step(images_u8, masks_u8, rng: Optional[int] = None) -> dict:
        if rng is None:
            rng = mix_seed(seed, calls[0])
            calls[0] += 1
        optimizer.zero_grad(set_to_none=True)
        loss, sums = 0.0, 0.0
        for i, (lo, hi, w) in enumerate(micro_batches(images_u8.shape[0], accum)):
            mloss, logits, targets = compute_gradients(
                model, images_u8[lo:hi], masks_u8[lo:hi], n_classes, use_kernels,
                rng if accum == 1 else mix_seed(rng, i), w)
            loss = loss + w * mloss
            sums = sums + _metric_sums(logits, targets, n_classes)
        optimizer.step()
        dice, iou = _metrics_from_sums(sums)
        return {"loss": loss, "dice": dice, "iou": iou}

    return step


def make_eval_step(model: torch.nn.Module, n_classes: int = 1) -> Callable:
    """The eval step ``(images_u8, masks_u8) -> {'loss', 'dice', 'iou'}``:
    an eval forward (``train=False``, no dropout) on the kernels under
    ``no_grad``."""

    @torch.no_grad()
    def step(images_u8, masks_u8) -> dict:
        images, targets = _inputs(model, images_u8, masks_u8, n_classes)
        logits = model(images, flat_logits=_flat_head(n_classes), train=False)
        loss = segmentation_loss(logits, targets, n_classes)
        dice, iou = _batch_metrics(logits, targets, n_classes)
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


def evaluate(eval_step: Callable, loader, device) -> Dict[str, float]:
    """Metrics over a whole loader, averaged uniformly over batches (the
    reference's weighting, partial last batch included).  Each batch's
    scalars stay on the device; one copy fetches them all at the end."""
    per_batch = [eval_step(images, masks) for images, masks in device_prefetch(loader, device)]
    return _fetch_means(per_batch)


@dataclass
class FitConfig:
    """``fit``'s settings, the JAX package's ``FitConfig``.  Fields whose
    machinery is not ported take only their off value: ``augment`` (None
    here until ROADMAP queue A item 5 ports it; JAX's default augments),
    ``segmented`` / ``seg_depth_split`` (item 10), ``checkpoint_manager``
    and ``tensorboard_dir`` (item 6)."""
    num_epochs: int = 100
    n_classes: int = 1
    augment: Any = None
    plateau_factor: float = 0.5
    plateau_patience: int = 5
    plateau_min_lr: float = 1e-7
    grad_accum: int = 1
    segmented: bool = False
    seg_depth_split: int = 0
    seed: int = 42
    log_every: int = 0  # batches; 0 = epoch lines only
    progress: bool = True
    checkpoint_manager: Any = None
    tensorboard_dir: Optional[str] = None
    verbose: bool = True


_NOT_PORTED = (("augment", "on-device augmentation", 5),
               ("segmented", "the segmented step", 10),
               ("seg_depth_split", "the segmented step", 10),
               ("checkpoint_manager", "checkpoints", 6),
               ("tensorboard_dir", "TensorBoard logging", 6))


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
    ``mix_seed(cfg.seed, e * 1_000_000 + k)``, k counted over the whole run,
    so a run resumed with ``start_epoch``, ``global_step``, ``history`` and
    ``scheduler`` (and the model's and optimizer's states) follows the
    trajectory of the run that was not stopped."""
    for name, what, item in _NOT_PORTED:
        if getattr(cfg, name):
            raise NotImplementedError(f"FitConfig.{name}: {what} is not ported yet "
                                      f"(ROADMAP queue A item {item})")
    if mesh is not None:
        raise NotImplementedError("fit(mesh=...): data parallelism is not ported yet "
                                  "(ROADMAP queue A item 9)")
    device = model.device
    train_step = make_train_step(model, optimizer, cfg.n_classes, grad_accum=cfg.grad_accum)
    eval_step = make_eval_step(model, cfg.n_classes)
    if scheduler is None:
        scheduler = make_plateau_scheduler(optimizer, cfg.plateau_factor,
                                           cfg.plateau_patience, cfg.plateau_min_lr)
    history = history if history is not None else empty_history()

    for epoch in range(start_epoch, cfg.num_epochs):
        t0 = time.time()
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        per_batch, n_images, progress = [], 0, None
        if cfg.verbose and cfg.progress:
            total = len(train_loader) if hasattr(train_loader, "__len__") else None
            progress = EpochProgress(epoch, cfg.num_epochs, total)
        for images, masks in device_prefetch(train_loader, device):
            m = train_step(images, masks, rng=mix_seed(cfg.seed, epoch * 1_000_000 + global_step))
            per_batch.append(m)
            n_images += images.shape[0]
            global_step += 1
            if progress is not None and len(per_batch) > 1:
                # the previous batch's scalars: that batch is done, so reading
                # them does not wait on the step just enqueued
                progress.update(len(per_batch) - 1, n_images - images.shape[0], per_batch[-2])
            if cfg.verbose and cfg.log_every and len(per_batch) % cfg.log_every == 0:
                live = {k: float(v) for k, v in per_batch[-1].items()}
                print(f"  epoch {epoch + 1} batch {len(per_batch)}: "
                      f"loss {live['loss']:.4f} dice {live['dice']:.4f} iou {live['iou']:.4f}")
        if progress is not None:
            progress.close()
        train_metrics = _fetch_means(per_batch)
        test_metrics = evaluate(eval_step, test_loader, device)
        # torch's scheduler sets the optimizer's learning rate itself
        scheduler.step(test_metrics["loss"])
        lr = get_learning_rate(optimizer)

        for split, metrics in (("train", train_metrics), ("test", test_metrics)):
            for k in METRICS:
                history[f"{split}_{k}"].append(metrics[k])
        history["learning_rates"].append(lr)

        dt = time.time() - t0
        if cfg.verbose:
            print(f"Epoch [{epoch + 1}/{cfg.num_epochs}]  "
                  f"({dt:.1f}s, {n_images / max(dt, 1e-9):.1f} img/s)")
            print(f"  Train - Loss: {train_metrics['loss']:.4f}, "
                  f"Dice: {train_metrics['dice']:.4f}, IoU: {train_metrics['iou']:.4f}")
            print(f"  Test  - Loss: {test_metrics['loss']:.4f}, "
                  f"Dice: {test_metrics['dice']:.4f}, IoU: {test_metrics['iou']:.4f}")
            print(f"  LR: {lr:.8f}")
    return history, global_step
