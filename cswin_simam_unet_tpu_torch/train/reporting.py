"""The live progress line of ``fit``.

Counterpart of ``EpochProgress`` in ``cswin_simam_unet_tpu/train/reporting.py``;
the CSV, the plot, the banner and the TensorBoard logger are not ported yet
(ROADMAP queue A item 6).
"""

from __future__ import annotations

import sys
import time
from typing import Optional


class EpochProgress:
    """In-epoch progress with loss, Dice and IoU.  It reads the scalars of a
    batch that has already completed and redraws at a bounded rate (0.5 s on
    a terminal, one full line every ``plain_interval_s`` on a plain stream),
    so drawing it does not wait on the device once a batch."""

    def __init__(self, epoch: int, num_epochs: int, total_batches: Optional[int] = None,
                 stream=None, refresh_s: float = 0.5, plain_interval_s: float = 30.0):
        self.stream = stream if stream is not None else sys.stderr
        self.epoch = epoch
        self.num_epochs = num_epochs
        self.total = total_batches
        self.isatty = bool(getattr(self.stream, "isatty", lambda: False)())
        self.refresh_s = refresh_s if self.isatty else plain_interval_s
        self._t0 = time.time()
        self._last = 0.0
        self._rendered = False

    def update(self, batch_idx: int, n_images: int, metrics) -> None:
        """metrics: a dict of (device or host) scalars of a completed batch."""
        now = time.time()
        if now - self._last < self.refresh_s:
            return
        self._last = now
        vals = {k: float(metrics[k]) for k in ("loss", "dice", "iou")}
        of = f"/{self.total}" if self.total else ""
        ips = n_images / max(now - self._t0, 1e-9)
        line = (f"epoch {self.epoch + 1}/{self.num_epochs} "
                f"batch {batch_idx}{of}: loss {vals['loss']:.4f} "
                f"dice {vals['dice']:.4f} iou {vals['iou']:.4f} "
                f"({ips:.1f} img/s)")
        if self.isatty:
            self.stream.write("\r  " + line + "\x1b[K")
            self._rendered = True
        else:
            self.stream.write("  " + line + "\n")
        self.stream.flush()

    def close(self) -> None:
        # clear the live line only if one was drawn
        if self.isatty and self._rendered:
            self.stream.write("\r\x1b[K")
            self.stream.flush()
