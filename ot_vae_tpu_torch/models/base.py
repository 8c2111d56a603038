"""Model base (counterpart: ``ot_vae_tpu/models/base.py``): the inference
flag and the inference transforms that wrap a model's public calls.

Training (losses, the optimizer, EMA, partial checkpoints) comes with the
training slice.
"""
from __future__ import annotations

import torch
from torch import nn

from ot_vae_tpu_torch.data.transforms import Identity, Transform

__all__ = ["VisionModel", "seeded_generator"]


def seeded_generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


class VisionModel(nn.Module):
    """Owns ``net`` and the inference transforms. With ``inference`` on,
    inputs pass through ``inference_preprocess`` and outputs through
    ``inference_postprocess``."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net
        self.inference_preprocess: Transform = Identity()
        self.inference_postprocess: Transform = Identity()
        self._inference = False

    @property
    def inference(self) -> bool:
        return self._inference

    @inference.setter
    def inference(self, on: bool):
        if on and (self.inference_preprocess is None or self.inference_postprocess is None):
            raise ValueError("inference mode needs both inference transforms")
        self._inference = on

    def maybe_preprocess(self, x: torch.Tensor) -> torch.Tensor:
        return self.inference_preprocess(x) if self._inference else x

    def maybe_postprocess(self, x: torch.Tensor) -> torch.Tensor:
        return self.inference_postprocess(x) if self._inference else x

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def default_generator(self) -> torch.Generator:
        """Deterministic default draw: successive calls step a per-model
        counter, as the JAX model folds a counter into a fixed key."""
        counter = getattr(self, "_sample_calls", 0)
        self._sample_calls = counter + 1
        return seeded_generator(counter, self.device)
