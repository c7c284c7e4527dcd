"""Reduce-on-plateau learning-rate schedule.

The JAX package's ``cswin_simam_unet_tpu/train/schedule.py`` is a
state machine written to match ``torch.optim.lr_scheduler.ReduceLROnPlateau``
(mode 'min', relative threshold 1e-4, eps 1e-8), stepped on the test loss
once an epoch.  The port uses torch's own scheduler, which sets the
learning rate of the optimizer's parameter groups itself.
"""

from __future__ import annotations

import torch
from torch.optim.lr_scheduler import ReduceLROnPlateau


def make_plateau_scheduler(optimizer: torch.optim.Optimizer, factor: float = 0.5,
                           patience: int = 5, min_lr: float = 1e-7,
                           cooldown: int = 0) -> ReduceLROnPlateau:
    """The schedule of ``fit``: torch's ``ReduceLROnPlateau`` with the JAX
    class's threshold (1e-4, relative) and eps (1e-8)."""
    return ReduceLROnPlateau(optimizer, mode="min", factor=factor, patience=patience,
                             threshold=1e-4, threshold_mode="rel", cooldown=cooldown,
                             min_lr=min_lr, eps=1e-8)
