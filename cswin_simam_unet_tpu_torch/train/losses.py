"""Segmentation losses in logits space.

Counterpart of ``cswin_simam_unet_tpu/train/losses.py``: binary
cross-entropy with logits, float32, mean over all elements, computed
stably.  Only the binary head (``n_classes == 1``) is ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy over all elements from logits (float32)."""
    return F.binary_cross_entropy_with_logits(logits.float(), targets.float())


def segmentation_loss(logits: torch.Tensor, targets: torch.Tensor,
                      n_classes: int = 1) -> torch.Tensor:
    """Binary BCE; the multi-class cross-entropy is not ported yet."""
    if n_classes != 1:
        raise NotImplementedError("multi-class segmentation loss is not ported yet "
                                  "(ROADMAP queue A item 4)")
    return bce_with_logits(logits, targets)
