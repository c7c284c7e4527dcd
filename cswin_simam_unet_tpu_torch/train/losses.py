"""Segmentation losses in logits space.

Counterpart of ``cswin_simam_unet_tpu/train/losses.py``: binary
cross-entropy with logits (the reference's loss, computed stably), the
multi-class softmax cross-entropy over integer labels and an optional soft
Dice term, all in float32 and averaged over every element.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy over all elements from logits (float32)."""
    return F.binary_cross_entropy_with_logits(logits.float(), targets.float())


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of logits (..., C) against integer labels
    (...), in float32."""
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def soft_dice_loss(logits: torch.Tensor, targets: torch.Tensor,
                   smooth: float = 1.0) -> torch.Tensor:
    """1 - soft Dice on the sigmoid probabilities, over all elements."""
    probs = torch.sigmoid(logits.float()).reshape(-1)
    t = targets.reshape(-1).float()
    inter = (probs * t).sum()
    return 1.0 - (2.0 * inter + smooth) / (probs.sum() + t.sum() + smooth)


def segmentation_loss(logits: torch.Tensor, targets: torch.Tensor,
                      n_classes: int = 1, dice_weight: float = 0.0) -> torch.Tensor:
    """Binary BCE (one class) or softmax cross-entropy over image-layout
    logits (several); the soft Dice term, weighted by ``dice_weight``, joins
    the binary loss only."""
    if n_classes == 1:
        loss = bce_with_logits(logits, targets)
    else:
        loss = softmax_cross_entropy(logits, targets)
    if dice_weight > 0.0 and n_classes == 1:
        loss = loss + dice_weight * soft_dice_loss(logits, targets)
    return loss
