"""Callback protocol and the built-in callbacks
and ``list_to_collage`` (counterpart: ``ot_vae_tpu/trainer/callbacks.py``).
The ``Collage`` callback arrives with slice 4c (ROADMAP).

The validation and test loops hand ``on_*_batch_end`` the eval step's
outputs: ``samples``, ``target``, ``kwargs``, ``preds`` and ``latents``."""
from __future__ import annotations

import dataclasses
import math
import os
import shutil
from pathlib import Path
from typing import List, Optional

import numpy as np

__all__ = ["Callback", "EarlyStopping", "ModelCheckpointCallback", "list_to_collage"]


class Callback:
    """Hook points of the training loop."""

    def on_fit_start(self, trainer, model): ...
    def on_fit_end(self, trainer, model): ...
    def on_train_epoch_start(self, trainer, model): ...
    def on_train_epoch_end(self, trainer, model): ...
    def on_train_batch_end(self, trainer, model, outputs, batch, batch_idx): ...
    def on_validation_epoch_start(self, trainer, model): ...
    def on_validation_batch_end(self, trainer, model, outputs, batch, batch_idx): ...
    def on_validation_epoch_end(self, trainer, model): ...
    def on_test_epoch_start(self, trainer, model): ...
    def on_test_batch_end(self, trainer, model, outputs, batch, batch_idx): ...
    def on_test_epoch_end(self, trainer, model): ...


def _signed(trainer, model, monitor: Optional[str], mode: Optional[str]):
    """(monitored value or None, +1 for max mode / −1 for min, monitor name)."""
    monitor = monitor or trainer.monitor
    value = trainer.logged_metrics.get(monitor)
    sign = 1.0 if (mode or model.mode) == "max" else -1.0
    return (None if value is None else float(value)), sign, monitor


@dataclasses.dataclass
class EarlyStopping(Callback):
    """Stop when the monitored metric has not improved by ``min_delta`` for
    ``patience`` validations."""

    monitor: Optional[str] = None
    mode: Optional[str] = None
    min_delta: float = 0.1
    patience: int = 5

    def __post_init__(self):
        self.best: Optional[float] = None
        self.count = 0

    def on_validation_epoch_end(self, trainer, model):
        value, sign, _ = _signed(trainer, model, self.monitor, self.mode)
        if value is None:
            return
        if self.best is None or sign * (value - self.best) > self.min_delta:
            self.best = value
            self.count = 0
        else:
            self.count += 1
            if self.count >= self.patience:
                trainer.should_stop = True


@dataclasses.dataclass
class ModelCheckpointCallback(Callback):
    """Keep the ``save_top_k`` best checkpoints on the monitored metric, one
    directory each (see ``trainer/checkpoint.py``)."""

    dirpath: str = "checkpoints"
    monitor: Optional[str] = None
    mode: Optional[str] = None
    save_top_k: int = 10
    filename: str = "epoch{epoch:02d}-{value:.3f}"

    def __post_init__(self):
        self.saved: List[tuple] = []  # (value, path), best first

    def on_validation_epoch_end(self, trainer, model):
        from ot_vae_tpu_torch.trainer.checkpoint import save_checkpoint

        value, sign, monitor = _signed(trainer, model, self.monitor, self.mode)
        if value is None:
            return
        path = Path(self.dirpath) / self.filename.format(epoch=trainer.current_epoch,
                                                         value=value)
        # admit when better than the worst saved entry (in signed space)
        worst = min((sign * v for v, _ in self.saved), default=-math.inf)
        if len(self.saved) < self.save_top_k or sign * value > worst:
            os.makedirs(self.dirpath, exist_ok=True)
            save_checkpoint(path, trainer.state, model,
                            metadata={"epoch": trainer.current_epoch, monitor: value})
            self.saved.append((value, str(path)))
            self.saved.sort(key=lambda t: sign * t[0], reverse=True)
            while len(self.saved) > self.save_top_k:
                _, stale = self.saved.pop()
                shutil.rmtree(stale, ignore_errors=True)

    @property
    def best_path(self) -> Optional[str]:
        return self.saved[0][1] if self.saved else None


def list_to_collage(images: List[np.ndarray], num_samples: int) -> np.ndarray:
    """One grid [rows · H, num_samples · W, C] from a list of NHWC batches:
    each batch's first ``num_samples`` images side by side make a row."""
    rows = [np.concatenate(list(np.asarray(imgs)[:num_samples]), axis=1) for imgs in images]
    return np.concatenate(rows, axis=0)
