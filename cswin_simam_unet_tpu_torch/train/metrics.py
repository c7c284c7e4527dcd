"""Segmentation metrics with the reference's semantics.

Counterpart of ``cswin_simam_unet_tpu/train/metrics.py``: Dice and IoU over
all elements with smooth 1e-6, on thresholded predictions (strict ``>``)
against possibly soft targets; for several classes the mean per-class Dice
and IoU of argmax predictions against one-hot targets.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dice_coefficient(pred: torch.Tensor, target: torch.Tensor,
                     smooth: float = 1e-6) -> torch.Tensor:
    """(2|P and T| + s) / (|P| + |T| + s) over flattened inputs."""
    pred, target = pred.reshape(-1).float(), target.reshape(-1).float()
    inter = (pred * target).sum()
    return (2.0 * inter + smooth) / (pred.sum() + target.sum() + smooth)


def iou_score(pred: torch.Tensor, target: torch.Tensor,
              smooth: float = 1e-6) -> torch.Tensor:
    """(|P and T| + s) / (|P or T| + s) over flattened inputs."""
    pred, target = pred.reshape(-1).float(), target.reshape(-1).float()
    inter = (pred * target).sum()
    return (inter + smooth) / (pred.sum() + target.sum() - inter + smooth)


def threshold_predictions(probs: torch.Tensor, thresh: float = 0.5) -> torch.Tensor:
    """Hard {0, 1} float32 predictions, ``probs > thresh``."""
    return (probs > thresh).float()


def multiclass_metrics(scores: torch.Tensor, target_onehot: torch.Tensor,
                       smooth: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean per-class Dice, mean per-class IoU) of the argmax of ``scores``
    (..., C), logits or probabilities, against one-hot targets (..., C)."""
    n_classes = scores.shape[-1]
    pred = F.one_hot(scores.argmax(-1), n_classes).float()
    target = target_onehot.float()
    dims = tuple(range(pred.ndim - 1))
    inter = (pred * target).sum(dims)
    sp, st = pred.sum(dims), target.sum(dims)
    dice = ((2.0 * inter + smooth) / (sp + st + smooth)).mean()
    iou = ((inter + smooth) / (sp + st - inter + smooth)).mean()
    return dice, iou


def multiclass_dice(probs: torch.Tensor, target_onehot: torch.Tensor,
                    smooth: float = 1e-6) -> torch.Tensor:
    """Mean per-class Dice (see :func:`multiclass_metrics`)."""
    return multiclass_metrics(probs, target_onehot, smooth)[0]
