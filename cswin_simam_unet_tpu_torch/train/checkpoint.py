"""Checkpoints: the full training state every epoch, and weights files.

Counterpart of ``cswin_simam_unet_tpu/train/checkpoint.py`` with
``torch.save`` in place of orbax.  Each saved epoch is one file,
``epoch_<N>.pt``, holding the model's and the optimizer's state dicts, the
plateau scheduler's state, the metric history, the epoch and the global
step: ``restore`` gives back what ``fit`` needs to go on along the
trajectory of the run that was not stopped.  The latest ``max_to_keep``
epochs are kept.  ``meta.json`` records the best test Dice and its epoch,
and that epoch's weights are kept outside the retention as
``best_weights.pth``, a state dict with the reference scripts' names (the
port's own), which loads strictly into the reference's model and the
port's.

Every file is written under a temporary name and then renamed over its
target, so a crash in the middle of a save leaves the previous file whole.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, Optional, Tuple

import torch

_EPOCH_FILE = re.compile(r"epoch_(\d+)\.pt$")


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_weights(path: str, model: torch.nn.Module) -> None:
    """The final-weights file: the model's state dict (reference names) as a
    ``.pth``, the counterpart of the reference's one
    ``torch.save(model.state_dict())``."""
    _atomic_save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)


def load_weights(path: str, model: torch.nn.Module) -> None:
    """Load a weights file (``.pth``/``.pt``/``.npz``) into ``model``,
    strictly, cast to the model's dtypes (``compat.io``)."""
    from ..compat.io import load_state_dict_file, load_state_dict_strict
    load_state_dict_strict(model, load_state_dict_file(path), source=path)


class CheckpointStore:
    """Epoch-granular checkpoints with best-Dice tracking."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._meta_path = os.path.join(self.directory, "meta.json")
        self._best_path = os.path.join(self.directory, "best_weights.pth")

    def _epoch_path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}.pt")

    def all_epochs(self) -> list:
        found = (_EPOCH_FILE.search(os.path.basename(p))
                 for p in glob.glob(os.path.join(self.directory, "epoch_*.pt")))
        return sorted(int(m.group(1)) for m in found if m)

    def _read_meta(self) -> Dict:
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                return json.load(f)
        return {"best_dice": -1.0, "best_epoch": 0}

    def _write_meta(self, meta: Dict) -> None:
        tmp = f"{self._meta_path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self._meta_path)

    def save_epoch(self, epoch: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                   scheduler, history: Dict[str, list], test_dice: float,
                   global_step: int = 0) -> None:
        _atomic_save({
            "model": model.state_dict(),
            "optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict() if scheduler is not None else None,
            "history": history,
            "epoch": int(epoch),
            "global_step": int(global_step),
        }, self._epoch_path(epoch))
        for old in self.all_epochs()[:-self.max_to_keep]:
            os.remove(self._epoch_path(old))
        meta = self._read_meta()
        if test_dice > meta.get("best_dice", -1.0):
            # the best epoch's weights outside the retention, which may
            # delete that epoch's checkpoint later
            save_weights(self._best_path, model)
            self._write_meta({"best_dice": float(test_dice), "best_epoch": int(epoch)})

    def latest_epoch(self) -> Optional[int]:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def _load(self, epoch: Optional[int], map_location) -> Tuple[dict, int]:
        epoch = epoch if epoch is not None else self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self._epoch_path(epoch), map_location=map_location,
                          weights_only=True), int(epoch)

    def restore(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                epoch: Optional[int] = None) -> Tuple[Optional[dict], Dict[str, list], int, int]:
        """Load the model's and the optimizer's states of ``epoch`` (the
        latest by default) in place, onto the model's device; return
        (scheduler state, history, epoch, global step).  The global step
        feeds ``fit`` so that the resumed run's seeds equal the unbroken
        run's."""
        payload, epoch = self._load(epoch, model.device)
        model.load_state_dict(payload["model"], strict=True)
        for state in payload["optimizer"]["state"].values():
            # Adam's step count lives on the host unless the optimizer is
            # capturable or fused (then load_state_dict moves it back): on
            # the device, each step would read it back once a parameter
            if isinstance(state.get("step"), torch.Tensor):
                state["step"] = state["step"].cpu()
        optimizer.load_state_dict(payload["optimizer"])
        return (payload["scheduler"], payload["history"], epoch,
                int(payload.get("global_step", 0)))

    def restore_weights(self, epoch: Optional[int] = None) -> Tuple[Dict[str, torch.Tensor], int]:
        """The model's state dict of ``epoch`` (the latest by default), on
        the CPU, and the epoch; no optimizer is built or read into."""
        payload, epoch = self._load(epoch, "cpu")
        return payload["model"], epoch

    def reset(self) -> None:
        """Clear every saved epoch and the best-Dice records: a fresh run
        into a directory of an older run's checkpoints must not inherit its
        epochs or its best Dice."""
        for epoch in self.all_epochs():
            os.remove(self._epoch_path(epoch))
        for path in (self._meta_path, self._best_path):
            if os.path.exists(path):
                os.remove(path)

    def best_epoch(self) -> Tuple[int, float]:
        meta = self._read_meta()
        return meta.get("best_epoch", 0), meta.get("best_dice", -1.0)

    def best_weights_path(self) -> Optional[str]:
        """The best-on-test-Dice weights file, once an epoch is saved."""
        return self._best_path if os.path.exists(self._best_path) else None

    def close(self) -> None:
        """Nothing stays open between saves; kept for JAX's interface."""
