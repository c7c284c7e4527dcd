"""Data: image/mask files and the split, the threaded loader, the
host-to-device prefetch and on-device augmentation."""

from .augment import AugmentConfig, augment_batch, augment_from_params, draw_params
from .dataset import SegmentationDataSource, train_test_indices
from .pipeline import DataLoader, device_prefetch

__all__ = ["AugmentConfig", "DataLoader", "SegmentationDataSource", "augment_batch",
           "augment_from_params", "device_prefetch", "draw_params", "train_test_indices"]
