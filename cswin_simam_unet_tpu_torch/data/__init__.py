"""Data: the host-to-device prefetch of ``fit``; the datasets, the loader
and augmentation are not ported yet (ROADMAP queue A item 5)."""

from .pipeline import device_prefetch

__all__ = ["device_prefetch"]
