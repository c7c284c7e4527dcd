"""Metric artifacts: the live progress line of ``fit``, the CSV, the plot,
the TensorBoard logger and the configuration banner.

Counterpart of ``cswin_simam_unet_tpu/train/reporting.py``, in the
reference's schema:

* CSV: 8 columns ``Epoch, Train_Loss, Train_Dice, Train_IoU, Test_Loss,
  Test_Dice, Test_IoU, Learning_Rate``, 6 decimals (8 for the rate), utf-8;
* PNG: a 2x2 grid, Loss / Dice / IoU (train blue, test red) and the rate
  (log scale, green), dpi 300.  ``matplotlib`` is imported when a plot is
  made, and only then;
* TensorBoard: scalars through ``tensorboardX`` where it is installed, else
  nothing.
"""

from __future__ import annotations

import csv
import sys
import time
from typing import Dict, Optional


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


def save_metrics_to_csv(history: Dict[str, list], path: str) -> None:
    epochs = len(history["train_loss"])
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["Epoch", "Train_Loss", "Train_Dice", "Train_IoU",
                    "Test_Loss", "Test_Dice", "Test_IoU", "Learning_Rate"])
        for i in range(epochs):
            w.writerow([
                i + 1,
                f"{history['train_loss'][i]:.6f}",
                f"{history['train_dice'][i]:.6f}",
                f"{history['train_iou'][i]:.6f}",
                f"{history['test_loss'][i]:.6f}",
                f"{history['test_dice'][i]:.6f}",
                f"{history['test_iou'][i]:.6f}",
                f"{history['learning_rates'][i]:.8f}",
            ])


def plot_metrics(history: Dict[str, list], path: str, title: str = "") -> None:
    """The 2x2 PNG; raises ImportError without ``matplotlib``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = range(1, len(history["train_loss"]) + 1)
    fig, axes = plt.subplots(2, 2, figsize=(14, 10))
    if title:
        fig.suptitle(title)
    panels = [("Loss", "train_loss", "test_loss"),
              ("Dice Coefficient", "train_dice", "test_dice"),
              ("IoU Score", "train_iou", "test_iou")]
    for ax, (name, tr, te) in zip(axes.flat, panels):
        ax.plot(epochs, history[tr], "b-", label=f"Train {name}")
        ax.plot(epochs, history[te], "r-", label=f"Test {name}")
        ax.set_xlabel("Epoch")
        ax.set_ylabel(name)
        ax.set_title(f"Training and Test {name}")
        ax.legend()
        ax.grid(True)
    ax = axes.flat[3]
    ax.plot(epochs, history["learning_rates"], "g-", label="Learning Rate")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Learning Rate")
    ax.set_title("Learning Rate Schedule")
    ax.set_yscale("log")
    ax.legend()
    ax.grid(True)
    fig.tight_layout()
    fig.savefig(path, dpi=300)
    plt.close(fig)


class TensorBoardLogger:
    """TensorBoard scalars of each epoch; does nothing without
    ``tensorboardX``."""

    def __init__(self, logdir: str):
        try:
            from tensorboardX import SummaryWriter
            self.writer = SummaryWriter(logdir)
        except ImportError:
            self.writer = None

    def log_epoch(self, epoch: int, train: Dict[str, float], test: Dict[str, float],
                  lr: float) -> None:
        if self.writer is None:
            return
        for k, v in train.items():
            self.writer.add_scalar(f"train/{k}", v, epoch)
        for k, v in test.items():
            self.writer.add_scalar(f"test/{k}", v, epoch)
        self.writer.add_scalar("learning_rate", lr, epoch)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


def config_banner(config: Dict) -> str:
    lines = ["=" * 50, "Training configuration", "=" * 50]
    for k, v in config.items():
        lines.append(f"  {k}: {v}")
    lines.append("=" * 50)
    return "\n".join(lines)
