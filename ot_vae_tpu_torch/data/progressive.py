"""Progressive (curriculum) transforms (counterpart:
``ot_vae_tpu/data/progressive.py``).

``PgTransform`` builds a transform from the epoch's entry of a schedule;
``ProgressiveTransform``, a trainer callback, sets the model's
``progressive_transform`` at every train epoch's start, and the model's
``batch_preprocess`` applies it to the training batches. The port has no
compiled step to rebuild, so it keeps no version counter.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

from ot_vae_tpu_torch.data.transforms import Compose
from ot_vae_tpu_torch.trainer.callbacks import Callback

__all__ = ["PgTransform", "PgCompose", "ProgressiveTransform"]


@dataclasses.dataclass
class PgTransform:
    """``transform_cls(*args_schedule[epoch])``; epochs past the schedule's
    end reuse its last entry."""

    transform_cls: Callable
    args_schedule: Sequence[Any]

    def at_epoch(self, epoch: int):
        args = self.args_schedule[min(epoch, len(self.args_schedule) - 1)]
        if not isinstance(args, (tuple, list)):
            args = (args,)
        return self.transform_cls(*args)


@dataclasses.dataclass
class PgCompose:
    """Several PgTransforms applied in order."""

    transforms: Sequence[PgTransform]

    def at_epoch(self, epoch: int):
        return Compose([t.at_epoch(epoch) for t in self.transforms])


@dataclasses.dataclass
class ProgressiveTransform(Callback):
    """Sets the model's ``progressive_transform`` to the schedule's entry of
    each train epoch."""

    schedule: Any  # PgTransform | PgCompose

    def on_train_epoch_start(self, trainer, model):
        model.progressive_transform = self.schedule.at_epoch(trainer.current_epoch)
