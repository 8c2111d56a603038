from ot_vae_tpu_torch.trainer.callbacks import (
    Callback,
    EarlyStopping,
    ModelCheckpointCallback,
    list_to_collage,
)
from ot_vae_tpu_torch.trainer.checkpoint import load_checkpoint, save_checkpoint
from ot_vae_tpu_torch.trainer.loggers import PrintLogger
from ot_vae_tpu_torch.trainer.state import TrainState
from ot_vae_tpu_torch.trainer.trainer import Trainer

__all__ = ["Trainer", "TrainState", "Callback", "EarlyStopping", "ModelCheckpointCallback",
           "PrintLogger", "save_checkpoint", "load_checkpoint", "list_to_collage"]
