"""Gaussian prior with the reparametrization trick
(counterpart: ``ot_vae_tpu/priors/gaussian.py``).

(μ, log σ²) are stacked on the last axis of the NHWC encoder output, and
z = μ + σ·ε with σ = exp(log σ² / 2).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ot_vae_tpu_torch.priors.base import PriorModule
from ot_vae_tpu_torch.utils import unsqueeze_like

__all__ = ["GaussianPrior"]


class GaussianPrior(PriorModule):
    """q(z|x) = N(μ(x), σ(x)²), p(z) = N(0, I).

    :param fixed_var: unit variance; with a ``time`` input the variance is
        scaled by the time temperature.
    """

    def __init__(self, fixed_var: bool = False):
        super().__init__()
        self.fixed_var = fixed_var

    def reparametrization(
        self, z: torch.Tensor, temperature: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Split into (mean, scale σ)."""
        if self.fixed_var:
            var = torch.ones_like(z)
            if temperature is not None:
                var = var * unsqueeze_like(temperature, var) + 1e-8
            return z, var
        mu, log_var = torch.chunk(z, 2, dim=-1)
        return mu, torch.exp(log_var / 2.0)

    def out_size(self, size: Sequence[int]) -> Tuple[int, ...]:
        if self.fixed_var:
            return tuple(size)
        out = list(size)
        out[-1] //= 2
        return tuple(out)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                time: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
        """z = μ + σ·ε; ε is ``noise`` when given, else drawn from ``generator``."""
        mean, scale = self.reparametrization(x, temperature=time)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                                device=mean.device)
        elif noise.shape != mean.shape:
            raise ValueError(f"noise shape {tuple(noise.shape)} != {tuple(mean.shape)}")
        return mean + scale * noise.to(mean.dtype)

    def sample(self, shape: Sequence[int], generator: Optional[torch.Generator] = None,
               device=None, **_) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=generator, device=device)
