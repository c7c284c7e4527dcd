"""Training of the port: losses, metrics and the training step."""

from .engine import make_optimizer, make_train_step
from .losses import bce_with_logits, segmentation_loss
from .metrics import dice_coefficient, iou_score, threshold_predictions

__all__ = ["bce_with_logits", "dice_coefficient", "iou_score", "make_optimizer",
           "make_train_step", "segmentation_loss", "threshold_predictions"]
