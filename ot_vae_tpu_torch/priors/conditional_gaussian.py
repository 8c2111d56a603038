"""Per-class learnable Gaussian prior N(μ_y, σ_y²)
(counterpart: ``ot_vae_tpu/priors/conditional_gaussian.py``).

SGD mode: the tables ``mu`` and ``log_std`` [num_classes, prod(dim)] are
parameters trained with the model. The EMA mode (``ema_decay``, the
``prior_stats`` collection) is on neither ViT path: its per-class sums are
``psum``'d across devices, so it arrives with multi-GPU training (slice 9).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ot_vae_tpu_torch.priors.gaussian import GaussianPrior

__all__ = ["ConditionalGaussianPrior"]


class ConditionalGaussianPrior(GaussianPrior):
    """q(z|x,y) = N(μ(x), σ(x)²), p(z|y) = N(μ_y, σ_y²).

    :param dim: latent size after reparametrization, e.g. (tokens, dim)
    :param num_classes: rows of the ``mu`` and ``log_std`` tables
    """

    def __init__(self, dim: Sequence[int] = (), num_classes: int = 10,
                 loss_coeff: float = 1.0, annealing_steps: int = 0,
                 reparam_dim: int = -1, ema_decay: Optional[float] = None):
        super().__init__(loss_coeff, annealing_steps, reparam_dim=reparam_dim)
        if ema_decay is not None and ema_decay > 0:
            raise NotImplementedError(
                "the EMA-fitted ConditionalGaussianPrior (ema_decay) arrives with "
                "multi-GPU training (slice 9)")
        self.dim = tuple(dim)
        self.num_classes = num_classes
        flat = math.prod(self.dim)
        # the JAX package's init: −U[0, 1)
        self.mu = nn.Parameter(-torch.rand(num_classes, flat))
        self.log_std = nn.Parameter(-torch.rand(num_classes, flat))

    def p(self, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-class prior (mean, scale), each [B, *dim]."""
        shape = (labels.shape[0], *self.dim)
        labels = labels.long()
        return self.mu[labels].reshape(shape), torch.exp(self.log_std[labels]).reshape(shape)

    def forward(self, x: torch.Tensor, step: Union[int, torch.Tensor] = 0,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None, **_):
        """z = μ + σ·ε with the closed-form KL to the class prior.

        :return: (z, per-sample loss [B] scaled for ``step``, artifacts)
        """
        if labels is None:
            raise ValueError("ConditionalGaussianPrior requires `labels`")
        q_mean, q_scale = self.reparametrization(x)
        p_mean, p_scale = self.p(labels)
        z = q_mean + q_scale * self._noise(q_mean, generator, noise)
        loss = self.closed_form_reverse_kl(q_mean, q_scale ** 2, p_mean, p_scale ** 2)
        artifacts = {"prior": (p_mean, p_scale), "distribution": (q_mean, q_scale)}
        return z, self.scale_loss(loss, step), artifacts

    def sample(self, shape: Sequence[int], generator: Optional[torch.Generator] = None,
               device=None, labels: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
        """μ_y + σ_y·ε for each label (``shape`` is [B, *dim])."""
        if labels is None:
            raise ValueError("ConditionalGaussianPrior.sample requires `labels`")
        p_mean, p_scale = self.p(labels)
        if tuple(shape) != tuple(p_mean.shape):
            raise ValueError(f"sample shape {tuple(shape)} != {tuple(p_mean.shape)}")
        eps = torch.randn(p_mean.shape, generator=generator, device=p_mean.device)
        return p_mean + p_scale * eps.to(p_mean.dtype)
