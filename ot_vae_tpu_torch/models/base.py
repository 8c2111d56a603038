"""Model base (counterpart: ``ot_vae_tpu/models/base.py``): the inference
flag and transforms that wrap a model's public calls, and what the trainer
reads from a model: the monitored metric and its mode, the learning rate,
the optimizer, gradient clipping and the EMA decay.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch
from torch import nn

from ot_vae_tpu_torch.data.transforms import Identity, Transform

__all__ = ["VisionModel", "seeded_generator", "clip_by_global_norm"]


def seeded_generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


@torch.no_grad()
def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by max_norm / ‖g‖ when the global 2-norm
    ‖g‖ reaches ``max_norm``, as ``optax.clip_by_global_norm`` does
    (g / ‖g‖ · max_norm, no epsilon). Decides on the device: no host sync.

    :return: the global norm before clipping
    """
    grads = [g for g in grads if g is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class VisionModel(nn.Module):
    """Owns ``net`` and the inference transforms. With ``inference`` on,
    inputs pass through ``inference_preprocess`` and outputs through
    ``inference_postprocess``.

    :param metrics: a ``MetricCollection`` the trainer's validation and test
        loops update (as ``val_metrics`` and ``test_metrics``)
    :param monitor: metric name (under ``val/metrics/``) the LR plateau and
        the callbacks watch, ``mode`` "max" or "min"
    :param learning_rate: Adam's initial learning rate
    :param ema_decay: decay of the EMA copy of the parameters; None keeps none
    :param gradient_clip_val: global-norm clip before Adam; None disables
    :param checkpoints: partial checkpoints (not ported yet)
    """

    def __init__(self, net: nn.Module, metrics=None, monitor: str = "psnr",
                 mode: str = "max", learning_rate: float = 1e-3,
                 ema_decay: Optional[float] = None,
                 gradient_clip_val: Optional[float] = None, checkpoints=None):
        super().__init__()
        if checkpoints:
            raise NotImplementedError(
                "checkpoints: partial checkpoints and frozen paths arrive with slice 9")
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.net = net
        self.metrics = metrics
        self.val_metrics = metrics.clone("val/metrics/") if metrics is not None else None
        self.test_metrics = metrics.clone("test/metrics/") if metrics is not None else None
        self.monitor = monitor
        self.mode = mode
        self.learning_rate = learning_rate
        self.ema_decay = ema_decay
        self.gradient_clip_val = gradient_clip_val
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

    def optimizer(self) -> torch.optim.Optimizer:
        """Adam(lr, betas (0.9, 0.999), eps 1e-8): optax ``adam``'s update
        m̂ / (sqrt(v̂) + eps). The trainer's LR plateau sets ``lr`` in its
        param group; clipping runs in the trainer before ``step``."""
        return torch.optim.Adam(self.net.parameters(), lr=self.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8)
