"""Multivariate Gaussian fitted from streaming moments (counterpart:
``ot_vae_tpu/distributions/gaussian.py``).

A :class:`GaussianModel` is a frozen config with functions over a
:class:`GaussianState` of sums (n, Σx, Σxxᵀ), as in the JAX package. With
``compensated`` the f32 sums carry Kahan compensation buffers; with
``update_decay`` they are exponential moving averages. ``fit`` reads
(mean, covariance) off the sums and shifts the covariance to PD.
Single process: the JAX package's cross-device sums arrive with multi-GPU
(ROADMAP).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ot_vae_tpu_torch.ops.matrix import STABILITY_CONST, full_f32, make_psd, mean_cov, symmetrize
from ot_vae_tpu_torch.ops.w2 import w2_gaussian
from ot_vae_tpu_torch.utils import ema

__all__ = ["GaussianState", "GaussianParams", "GaussianModel"]


@dataclasses.dataclass(frozen=True)
class GaussianState:
    """Streaming sums, with the Kahan compensation of s1 and s2 (None when
    the model is not ``compensated``)."""

    n: torch.Tensor  # [*L]
    s1: torch.Tensor  # [*L, D]
    s2: torch.Tensor  # [*L, D, D] ([*L, D] when diag)
    c1: Optional[torch.Tensor] = None
    c2: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "GaussianState":
        return dataclasses.replace(self, **changes)


def _kahan_add(total: torch.Tensor, comp: torch.Tensor, add: torch.Tensor):
    """One compensated-summation step, (new total, new compensation). Each
    line is its own rounded f32 op: (t − total) − y is the rounding error
    of the addition only while nothing fuses or reassociates them."""
    y = add - comp
    t = total + y
    comp_new = (t - total) - y
    return t, comp_new


class GaussianParams(NamedTuple):
    mean: torch.Tensor  # [*L, D]
    cov: torch.Tensor  # [*L, D, D] ([*L, D] when diag)


def _cholesky(matrices: torch.Tensor) -> torch.Tensor:
    """Cholesky factor, NaN where a matrix is not PD (as JAX's, which does
    not raise): per element, without a host sync."""
    chol, info = torch.linalg.cholesky_ex(matrices)
    return torch.where((info != 0)[..., None, None], torch.full_like(chol, math.nan), chol)


@dataclasses.dataclass(frozen=True)
class GaussianModel:
    """:param leading_shape: independent Gaussians fitted side by side [*L]
    :param dim: feature dimension D
    :param diag: diagonal covariance
    :param update_decay: EMA decay of the sums (None: plain sums)
    :param compensated: Kahan-compensated plain sums
    """

    leading_shape: Tuple[int, ...] = ()
    dim: int = 1
    diag: bool = False
    update_decay: Optional[float] = None
    compensated: bool = False
    dtype: torch.dtype = torch.float32

    # ------------------------------------------------------------- streaming

    def init(self, device) -> GaussianState:
        """Zero sums on ``device``."""
        L, D = self.leading_shape, self.dim
        z1 = torch.zeros((*L, D), dtype=self.dtype, device=device)
        z2 = torch.zeros((*L, D) if self.diag else (*L, D, D), dtype=self.dtype, device=device)
        return GaussianState(n=torch.zeros(L, dtype=self.dtype, device=device), s1=z1, s2=z2,
                             c1=torch.zeros_like(z1) if self.compensated else None,
                             c2=torch.zeros_like(z2) if self.compensated else None)

    @full_f32
    def _batch_stats(self, samples: torch.Tensor,
                     sample_weights: Optional[torch.Tensor] = None):
        """(n, Σx, Σxxᵀ) of a batch [*L, B, D]; ``sample_weights`` [*L, B]
        weight each sample (0 leaves it out)."""
        samples = samples.to(self.dtype)
        if sample_weights is None:
            n = torch.full(self.leading_shape, samples.shape[-2], dtype=self.dtype,
                           device=samples.device)
            weighted = samples
        else:
            w = sample_weights.to(self.dtype)
            n = torch.broadcast_to(w.sum(-1), self.leading_shape)
            weighted = samples * w[..., None]
        s1 = weighted.sum(-2)
        s2 = (weighted * samples).sum(-2) if self.diag else weighted.mT @ samples
        return n, s1, s2

    def update(self, state: GaussianState, samples: torch.Tensor,
               sample_weights: Optional[torch.Tensor] = None) -> GaussianState:
        """Add a batch [*L, B, D] to the sums."""
        n, s1, s2 = self._batch_stats(samples, sample_weights)
        d = self.update_decay
        if self.compensated and d is None:
            new_s1, new_c1 = _kahan_add(state.s1, state.c1, s1)
            new_s2, new_c2 = _kahan_add(state.s2, state.c2, s2)
            return GaussianState(n=state.n + n, s1=new_s1, s2=new_s2, c1=new_c1, c2=new_c2)
        return state.replace(n=ema(state.n, n, d), s1=ema(state.s1, s1, d),
                             s2=ema(state.s2, s2, d))

    def fit(self, state: GaussianState,
            samples: Optional[torch.Tensor] = None) -> GaussianParams:
        """(mean, covariance) from the sums, after adding ``samples`` when
        given; variances floored at ``STABILITY_CONST``, a full covariance
        symmetrized and shifted to PD."""
        if samples is not None:
            state = self.update(state, samples)
        n = torch.clamp_min(state.n, STABILITY_CONST)
        mean, cov = mean_cov(state.s1, state.s2, n, diag=self.diag)
        if self.diag:
            cov = torch.clamp_min(cov, STABILITY_CONST)
        else:
            cov = make_psd(symmetrize(cov), strict=True, method="auto")
        return GaussianParams(mean, cov)

    # ------------------------------------------------------------- evaluation

    def log_prob(self, params: GaussianParams, samples: torch.Tensor) -> torch.Tensor:
        """log N(x | μ, Σ) of samples [*L, B, D] → [*L, B]."""
        mean, cov = params
        x = samples - mean[..., None, :]
        if self.diag:
            logdet = torch.log(cov).sum(-1)[..., None]
            maha = torch.sum(x ** 2 / cov[..., None, :], dim=-1)
        else:
            chol = _cholesky(cov)
            # one triangular solve per leading element over all B samples
            y = torch.linalg.solve_triangular(chol, x.mT, upper=False)  # [*L, D, B]
            logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)[..., None]
            maha = torch.sum(y ** 2, dim=-2)
        return -0.5 * (maha + logdet + self.dim * math.log(2.0 * math.pi))

    @full_f32
    def sample(self, params: GaussianParams, generator: torch.Generator,
               batch_size: int) -> torch.Tensor:
        """Draws [*L, B, D] with ε from ``generator`` (on the params' device)."""
        mean, cov = params
        eps = torch.randn((*self.leading_shape, batch_size, self.dim), generator=generator,
                          dtype=self.dtype, device=mean.device)
        if self.diag:
            return mean[..., None, :] + eps * torch.sqrt(cov)[..., None, :]
        chol = _cholesky(make_psd(symmetrize(cov), strict=True, method="auto"))
        return mean[..., None, :] + eps @ chol.mT

    def w2(self, params: GaussianParams, other: GaussianParams) -> torch.Tensor:
        """Squared W2 to another Gaussian (diagonal or full)."""
        cov_a = torch.diag_embed(params.cov) if self.diag else params.cov
        cov_b = torch.diag_embed(other.cov) if other.cov.shape == other.mean.shape else other.cov
        return w2_gaussian(params.mean, other.mean, cov_a, cov_b, make_pd=True)

    # ------------------------------------------------------------- autograd fit

    def init_trainable(self, generator: torch.Generator) -> dict:
        """Unconstrained parameters for fitting by gradient descent: a mean,
        and log-variances (diag) or a matrix whose lower triangle with an
        exponentiated diagonal is the Cholesky factor."""
        L, D = self.leading_shape, self.dim
        mean = torch.randn((*L, D), generator=generator, dtype=self.dtype,
                           device=generator.device)
        raw = torch.zeros((*L, D) if self.diag else (*L, D, D), dtype=self.dtype,
                          device=generator.device)
        return {"mean": mean, "scale_raw": raw}

    @full_f32
    def constrain(self, trainable: dict) -> GaussianParams:
        mean, raw = trainable["mean"], trainable["scale_raw"]
        if self.diag:
            return GaussianParams(mean, torch.exp(raw))
        tril = torch.tril(raw, -1) + torch.diag_embed(
            torch.exp(torch.diagonal(raw, dim1=-2, dim2=-1)))
        return GaussianParams(mean, tril @ tril.mT)

    def nll(self, trainable: dict, samples: torch.Tensor) -> torch.Tensor:
        """Mean negative log-likelihood, the gradient-descent loss."""
        return -torch.mean(self.log_prob(self.constrain(trainable), samples))
