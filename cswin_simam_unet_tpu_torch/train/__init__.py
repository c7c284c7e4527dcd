"""Training of the port: losses, metrics, the training and eval steps, the
segmented training step, the plateau schedule and the epoch loop ``fit``."""

from .engine import (FitConfig, empty_history, evaluate, fit, get_learning_rate,
                     make_eval_step, make_optimizer, make_train_step, set_learning_rate)
from .losses import bce_with_logits, segmentation_loss, soft_dice_loss, softmax_cross_entropy
from .metrics import (dice_coefficient, iou_score, multiclass_dice, multiclass_metrics,
                      threshold_predictions)
from .reporting import EpochProgress
from .schedule import make_plateau_scheduler
from .segmented import build_segments, make_segmented_train_step, segment_param_keys

__all__ = ["EpochProgress", "FitConfig", "bce_with_logits", "build_segments",
           "dice_coefficient", "empty_history", "evaluate", "fit", "get_learning_rate",
           "iou_score", "make_eval_step", "make_optimizer", "make_plateau_scheduler",
           "make_segmented_train_step", "make_train_step", "multiclass_dice",
           "multiclass_metrics", "segment_param_keys", "segmentation_loss", "set_learning_rate",
           "soft_dice_loss", "softmax_cross_entropy", "threshold_predictions"]
