"""The training step.

Counterpart of ``cswin_simam_unet_tpu/train/engine.py::make_optimizer`` and
``make_train_step`` for the binary head without augmentation or gradient
accumulation: uint8 images and masks in, the masks unshuffled to the flat
logit layout while still uint8, forward with flat logits, BCE, backward,
AdamW, and Dice / IoU thresholded at 0 on the logits (``sigmoid(x) > 0.5``
exactly when ``x > 0``).  The forward is a training forward
(``train=True``): dropout, attention dropout and drop-path act at the
model's rates, with randomness from a host seed that the step hands down;
the module's ``training`` flag is never set or read.  Augmentation, gradient
accumulation, the L2-coupled Adam and the plateau schedule are not ported
yet (ROADMAP queue A).
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from ..models.cswin import FLAT_HEAD_FACTOR
from ..ops.dropout import mix_seed
from ..ops.windows import pixel_unshuffle
from .losses import segmentation_loss
from .metrics import dice_coefficient, iou_score, threshold_predictions


def make_optimizer(kind: str, learning_rate: float, weight_decay: float,
                   params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """'adamw': torch AdamW (decoupled decay), the update rule of the JAX
    package's ``optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay)``."""
    if kind == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    if kind == "adam":
        raise NotImplementedError("the L2-coupled 'adam' optimizer is not ported yet "
                                  "(ROADMAP queue A item 4)")
    raise ValueError(f"unknown optimizer: {kind}")


def _to_device(x, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    if t.dtype != torch.uint8:
        raise TypeError(f"the training step takes uint8 images and masks, got {t.dtype}")
    return t.to(device, non_blocking=True)


def compute_gradients(model: torch.nn.Module, images_u8, masks_u8, n_classes: int = 1,
                      use_kernels: bool = True, rng=None):
    """Training forward (``train=True``, dropout randomness from the host
    seed ``rng``) with flat logits, loss and backward on one uint8 batch; the
    gradients are added to the parameters' ``.grad``.  Returns the loss, the
    flat logits and the flat targets, detached."""
    device = model.device
    images = _to_device(images_u8, device).float() / 255.0
    # unshuffle while uint8: the same values, a quarter of the bytes
    masks = pixel_unshuffle(_to_device(masks_u8, device), FLAT_HEAD_FACTOR)
    targets = masks.float() / 255.0
    logits = model(images, use_kernels=use_kernels, flat_logits=True, train=True, rng=rng)
    loss = segmentation_loss(logits, targets, n_classes)
    loss.backward()
    return loss.detach(), logits.detach(), targets


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    n_classes: int = 1, use_kernels: bool = True,
                    augment=None, grad_accum: int = 1, seed: int = 0) -> Callable:
    """The step ``(images_u8 (B, H, W, C), masks_u8 (B, H, W, 1)) ->
    {'loss', 'dice', 'iou'}`` (0-d float32 tensors on the model's device;
    reading them synchronises).  One optimizer step per call.  The step owns
    a counter: call k runs its training forward with the host seed
    ``mix_seed(seed, k)``, so two steps made from the same seed and weights
    drop the same elements and give the same loss."""
    if n_classes != 1:
        raise NotImplementedError("the multi-class training step is not ported yet "
                                  "(ROADMAP queue A item 4)")
    if augment is not None:
        raise NotImplementedError("on-device augmentation is not ported yet "
                                  "(ROADMAP queue A item 5)")
    if grad_accum != 1:
        raise NotImplementedError("gradient accumulation is not ported yet "
                                  "(ROADMAP queue A item 4)")

    calls = [0]

    def step(images_u8, masks_u8) -> dict:
        optimizer.zero_grad(set_to_none=True)
        loss, logits, targets = compute_gradients(model, images_u8, masks_u8, n_classes,
                                                  use_kernels, mix_seed(seed, calls[0]))
        calls[0] += 1
        optimizer.step()
        with torch.no_grad():
            preds = threshold_predictions(logits.float(), 0.0)
            return {"loss": loss, "dice": dice_coefficient(preds, targets),
                    "iou": iou_score(preds, targets)}

    return step
