"""Prior contract (counterpart: ``ot_vae_tpu/priors/base.py``).

A prior is an ``nn.Module`` with::

    forward(x, step=0, generator=None, noise=None, **cond) -> (z, loss [B], artifacts)
    sample(shape, generator=None, device=None, **cond) -> z
    out_size(size) -> size

``loss`` is the per-sample prior loss, already scaled by ``loss_coeff`` and
the cosine warm-up of :func:`annealing_coeff`.
"""
from __future__ import annotations

import math
from typing import Union

import torch
from torch import nn

__all__ = ["annealing_coeff", "empirical_reverse_kl", "PriorModule"]


def annealing_coeff(step: Union[int, torch.Tensor], annealing_steps: int) -> torch.Tensor:
    """Cosine warm-up in [0, 1]; 1 once past ``annealing_steps``."""
    if annealing_steps <= 0:
        return torch.tensor(1.0)
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = 0.5 * torch.cos(math.pi * (s / annealing_steps + 1.0)) + 0.5
    return torch.where(s < annealing_steps, warm, torch.ones_like(warm))


def empirical_reverse_kl(log_prob_p: torch.Tensor, log_prob_q: torch.Tensor,
                         z: torch.Tensor) -> torch.Tensor:
    """Monte-Carlo KL(q || p) from per-element log-probs evaluated at z,
    reduced over all non-batch dims."""
    diff = log_prob_q - log_prob_p
    return diff.reshape(diff.shape[0], -1).sum(dim=-1)


class PriorModule(nn.Module):
    """Base class carrying the loss coefficient and its warm-up."""

    def __init__(self, loss_coeff: float = 1.0, annealing_steps: int = 0):
        super().__init__()
        self.loss_coeff = loss_coeff
        self.annealing_steps = annealing_steps

    def scale_loss(self, loss: torch.Tensor, step: Union[int, torch.Tensor]) -> torch.Tensor:
        coeff = annealing_coeff(step, self.annealing_steps).to(loss.device)
        return loss * self.loss_coeff * coeff
