"""Explicit train state (counterpart: ``TrainState``,
``ot_vae_tpu/trainer/state.py``).

The parameters and buffers (batch-norm running statistics) live in the
model, as PyTorch keeps them; the state holds the step counter, the model,
its optimizer and the EMA copy of the parameters, and gathers them into one
state dict for checkpoints.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ot_vae_tpu_torch.utils import ema

__all__ = ["TrainState"]


@dataclasses.dataclass
class TrainState:
    step: int
    net: nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def create(cls, net: nn.Module, optimizer: torch.optim.Optimizer,
               ema_decay: Optional[float] = None) -> "TrainState":
        ema = None
        if ema_decay is not None:
            ema = {k: p.detach().clone() for k, p in net.named_parameters()}
        return cls(step=0, net=net, optimizer=optimizer, ema_params=ema)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.net.named_parameters())

    @torch.no_grad()
    def update_ema(self, decay: float):
        """ema ← ema·decay + params·(1 − decay)."""
        if self.ema_params is None:
            return
        params = self.params
        for k, e in self.ema_params.items():
            e.copy_(ema(e, params[k], decay))

    @contextlib.contextmanager
    def ema_swapped(self):
        """The EMA parameters in the net for the duration of the block (a
        no-op without an EMA copy)."""
        if self.ema_params is None:
            yield
            return
        params = self.params
        with torch.no_grad():
            saved = {k: p.detach().clone() for k, p in params.items()}
            for k, e in self.ema_params.items():
                params[k].copy_(e)
        try:
            yield
        finally:
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(saved[k])

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.net.state_dict(),
                "optimizer": self.optimizer.state_dict(), "ema_params": self.ema_params}
