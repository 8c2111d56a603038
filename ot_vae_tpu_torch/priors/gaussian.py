"""Gaussian prior with the reparametrization trick
(counterpart: ``ot_vae_tpu/priors/gaussian.py``).

(μ, log σ²) are stacked on the ``reparam_dim`` axis of the encoder output
(the last, channels-last axis of NHWC by default; −2, the token axis, for the
conditional ViT), and z = μ + σ·ε with σ = exp(log σ² / 2). The loss is the closed-form reverse
KL(q || N(0, I)) per sample, or its Monte-Carlo estimate at z.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

from ot_vae_tpu_torch.priors.base import PriorModule, empirical_reverse_kl
from ot_vae_tpu_torch.utils import unsqueeze_like

__all__ = ["GaussianPrior"]


def _normal_log_prob(x, mean, var):
    return -0.5 * (torch.log(2.0 * math.pi * var) + (x - mean) ** 2 / var)


class GaussianPrior(PriorModule):
    """q(z|x) = N(μ(x), σ(x)²), p(z) = N(0, I).

    :param fixed_var: unit variance; with a ``time`` input the variance is
        scaled by the time temperature.
    :param empirical_kl: Monte-Carlo KL at z instead of the closed form.
    :param reparam_dim: axis carrying the stacked (μ, log σ²)
    """

    def __init__(self, loss_coeff: float = 1.0, annealing_steps: int = 0,
                 empirical_kl: bool = False, fixed_var: bool = False,
                 reparam_dim: int = -1):
        super().__init__(loss_coeff, annealing_steps)
        self.empirical_kl = empirical_kl
        self.fixed_var = fixed_var
        self.reparam_dim = reparam_dim

    def reparametrization(
        self, z: torch.Tensor, temperature: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Split into (mean, scale σ)."""
        if self.fixed_var:
            var = torch.ones_like(z)
            if temperature is not None:
                var = var * unsqueeze_like(temperature, var) + 1e-8
            return z, var
        mu, log_var = torch.chunk(z, 2, dim=self.reparam_dim)
        return mu, torch.exp(log_var / 2.0)

    @staticmethod
    def closed_form_reverse_kl(q_mean, q_var, p_mean, p_var) -> torch.Tensor:
        """KL(q, p) for Gaussians given variances, reduced over non-batch dims."""
        kl = 0.5 * ((q_mean - p_mean) ** 2 / p_var + torch.log(p_var) - torch.log(q_var)
                    + q_var / p_var - 1.0)
        return kl.reshape(kl.shape[0], -1).sum(dim=-1)

    def out_size(self, size: Sequence[int]) -> Tuple[int, ...]:
        if self.fixed_var:
            return tuple(size)
        out = list(size)
        out[self.reparam_dim] //= 2
        return tuple(out)

    @staticmethod
    def _noise(q_mean: torch.Tensor, generator: Optional[torch.Generator],
               noise: Optional[torch.Tensor]) -> torch.Tensor:
        """ε in q_mean's shape and dtype: ``noise`` when given, else drawn
        from ``generator``."""
        if noise is None:
            return torch.randn(q_mean.shape, generator=generator, dtype=q_mean.dtype,
                               device=q_mean.device)
        if noise.shape != q_mean.shape:
            raise ValueError(f"noise shape {tuple(noise.shape)} != {tuple(q_mean.shape)}")
        return noise.to(q_mean.dtype)

    def forward(self, x: torch.Tensor, step: Union[int, torch.Tensor] = 0,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                time: Optional[torch.Tensor] = None, **_):
        """z = μ + σ·ε; ε is ``noise`` when given, else drawn from ``generator``.

        :return: (z, per-sample loss [B] scaled for ``step``, artifacts
            ``{"prior": (p_mean, p_scale), "distribution": (q_mean, q_scale)}``)
        """
        q_mean, q_scale = self.reparametrization(x, temperature=time)
        p_mean, p_scale = self.reparametrization(torch.zeros_like(x))
        z = q_mean + q_scale * self._noise(q_mean, generator, noise)
        if self.empirical_kl:
            loss = empirical_reverse_kl(_normal_log_prob(z, p_mean, p_scale ** 2),
                                        _normal_log_prob(z, q_mean, q_scale ** 2), z)
        else:
            loss = self.closed_form_reverse_kl(q_mean, q_scale ** 2, p_mean, p_scale ** 2)
        artifacts = {"prior": (p_mean, p_scale), "distribution": (q_mean, q_scale)}
        return z, self.scale_loss(loss, step), artifacts

    def sample(self, shape: Sequence[int], generator: Optional[torch.Generator] = None,
               device=None, **_) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=generator, device=device)
