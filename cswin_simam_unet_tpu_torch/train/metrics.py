"""Segmentation metrics with the reference's semantics.

Counterpart of ``cswin_simam_unet_tpu/train/metrics.py``: Dice and IoU over
all elements with smooth 1e-6, on thresholded predictions (strict ``>``)
against possibly soft targets.
"""

from __future__ import annotations

import torch


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
