"""Gaussian mixture fitted by streaming mini-batch k-means (counterpart:
``ot_vae_tpu/distributions/gmm.py``).

Per component the state keeps the weight sum and the weighted Σx and Σxxᵀ
(EMA with ``update_decay``, Laplace-smoothed counts), and the means and
covariances they give. Samples are assigned by their posterior energy (the
component's log-density plus the log mixture weight) under the codebook's
modes (:func:`ot_vae_tpu_torch.distributions.codebook.assign_from_energy`);
the first batch a state sees seeds its means by farthest-point seeding.
Random draws take a ``torch.Generator`` where the JAX package takes a key.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ot_vae_tpu_torch.distributions.codebook import (
    _EPS,
    Assignment,
    _categorical,
    assign_from_energy,
    kmeanspp_init,
)
from ot_vae_tpu_torch.distributions.gaussian import GaussianModel, GaussianParams
from ot_vae_tpu_torch.ops.matrix import STABILITY_CONST, full_f32, make_psd, mean_cov, symmetrize
from ot_vae_tpu_torch.ops.w2 import batch_ot_gmm, gaussian_barycenter
from ot_vae_tpu_torch.utils import ema, laplace_smoothing

__all__ = ["GMMState", "GMMParams", "GMMModel"]


@dataclasses.dataclass(frozen=True)
class GMMState:
    mean: torch.Tensor  # [*L, K, D]
    cov: torch.Tensor  # [*L, K, D, D] ([*L, K, D] when diag)
    n_obs: torch.Tensor  # [*L, K]
    s1: torch.Tensor  # [*L, K, D]
    s2: torch.Tensor  # [*L, K, D, D] ([*L, K, D] when diag)
    initialized: bool

    def replace(self, **changes) -> "GMMState":
        return dataclasses.replace(self, **changes)


class GMMParams(NamedTuple):
    mean: torch.Tensor
    cov: torch.Tensor
    weights: torch.Tensor  # [*L, K]


@dataclasses.dataclass(frozen=True)
class GMMModel:
    """Static config and state transforms of a K-component mixture: per-phase
    assignment modes with temperature and top-k, ``kmeans_iter`` Lloyd
    iterations in :meth:`fit`, EMA and Laplace smoothing of the sums."""

    leading_shape: Tuple[int, ...] = ()
    dim: int = 1
    n_components: int = 16
    diag: bool = False
    topk: Optional[int] = None
    temperature: float = 1.0
    training_mode: str = "argmax"
    inference_mode: str = "argmax"
    kmeans_iter: int = 100
    laplace_eps: Optional[float] = 1e-5
    update_decay: Optional[float] = None
    dtype: torch.dtype = torch.float32

    @property
    def _component_gaussian(self) -> GaussianModel:
        """One Gaussian per component, the components folded into the
        leading shape."""
        return GaussianModel(leading_shape=(*self.leading_shape, self.n_components),
                             dim=self.dim, diag=self.diag, dtype=self.dtype)

    # ------------------------------------------------------------- state

    def init(self, generator: torch.Generator) -> GMMState:
        """Random means and unit covariances on the generator's device."""
        L, K, D = self.leading_shape, self.n_components, self.dim
        device = generator.device
        if self.diag:
            cov = torch.ones((*L, K, D), dtype=self.dtype, device=device)
        else:
            cov = torch.eye(D, dtype=self.dtype, device=device).expand(*L, K, D, D).clone()
        return GMMState(
            mean=torch.randn((*L, K, D), generator=generator, dtype=self.dtype, device=device),
            cov=cov, n_obs=torch.zeros((*L, K), dtype=self.dtype, device=device),
            s1=torch.zeros((*L, K, D), dtype=self.dtype, device=device),
            s2=torch.zeros_like(cov), initialized=False)

    def params(self, state: GMMState) -> GMMParams:
        """Means, covariances and the mixture weights (uniform before any
        observation)."""
        total = state.n_obs.sum(-1, keepdim=True)
        uniform = torch.full_like(state.n_obs, 1.0 / self.n_components)
        weights = torch.where(total > _EPS, state.n_obs / torch.clamp_min(total, _EPS), uniform)
        return GMMParams(state.mean, state.cov, weights)

    # ------------------------------------------------------------- energy/assign

    def energy(self, params: GMMParams, samples: torch.Tensor) -> torch.Tensor:
        """Posterior energy of samples [*L, B, D] → [*L, B, K]."""
        lp = self._component_gaussian.log_prob(GaussianParams(params.mean, params.cov),
                                               samples[..., None, :, :])  # [*L, K, B]
        return lp.mT + torch.log(params.weights + _EPS)[..., None, :]

    def assign(self, params: GMMParams, samples: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               training: bool = True) -> Assignment:
        """Assignment under the training or inference mode."""
        mode = self.training_mode if training else self.inference_mode
        return assign_from_energy(self.energy(params, samples), mode, self.n_components,
                                  self.temperature, self.topk, generator)

    # ------------------------------------------------------------- k-means

    @full_f32
    def _sums(self, assignment: Assignment, samples: torch.Tensor):
        """Weighted (count, Σx, Σxxᵀ) per component."""
        w = assignment.weights  # [*L, B, K]
        x = samples.to(w.dtype)
        w_sum = w.sum(-2)
        wt = w.mT  # [*L, K, B]
        if self.diag:
            return w_sum, wt @ x, wt @ x ** 2
        # the per-sample outer products flattened: one [K, B] x [B, D²] product
        d = x.shape[-1]
        xx = (x[..., :, None] * x[..., None, :]).reshape(*x.shape[:-1], d * d)
        return w_sum, wt @ x, (wt @ xx).reshape(*w_sum.shape, d, d)

    def _params_from_sums(self, state: GMMState, w_sum, s1, s2,
                          decay_buffers: bool) -> GMMState:
        """Components hit by the sums take their new moments (merged into
        the buffers by EMA with ``decay_buffers``); the others keep theirs."""
        hit = w_sum > _EPS
        hit1 = hit[..., None]
        hit2 = hit1 if self.diag else hit[..., None, None]
        if decay_buffers:
            d = self.update_decay
            w_sum, s1, s2 = (ema(state.n_obs, w_sum, d), ema(state.s1, s1, d),
                             ema(state.s2, s2, d))
        n_obs = torch.where(hit, w_sum, state.n_obs)
        s1_b = torch.where(hit1, s1, state.s1)
        s2_b = torch.where(hit2, s2, state.s2)
        n_smooth = laplace_smoothing(n_obs, self.n_components, self.laplace_eps)
        mean, cov = mean_cov(s1_b, s2_b, torch.clamp_min(n_smooth, _EPS), diag=self.diag)
        if self.diag:
            cov = torch.clamp_min(cov, STABILITY_CONST)
        else:
            cov = make_psd(symmetrize(cov), strict=True, method="auto")
        return state.replace(mean=torch.where(hit1, mean, state.mean),
                             cov=torch.where(hit2, cov, state.cov),
                             n_obs=n_obs, s1=s1_b, s2=s2_b)

    def _maybe_init(self, state: GMMState, samples: torch.Tensor,
                    generator: Optional[torch.Generator]) -> GMMState:
        """Farthest-point seeding of the means on the first batch a state
        sees."""
        if state.initialized:
            return state
        seeds = torch.broadcast_to(samples.to(self.dtype),
                                   (*self.leading_shape, *samples.shape[-2:]))
        return state.replace(mean=kmeanspp_init(seeds, self.n_components, generator),
                             n_obs=state.n_obs + 1.0, initialized=True)

    def update(self, state: GMMState, samples: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               sample_weights: Optional[torch.Tensor] = None) -> GMMState:
        """One streaming k-means step on a batch [*L, B, D];
        ``sample_weights`` [*L, B] down-weight samples."""
        state = self._maybe_init(state, samples, generator)
        assignment = self.assign(self.params(state), samples, generator, training=True)
        if sample_weights is not None:
            assignment = assignment._replace(
                weights=assignment.weights * sample_weights[..., None])
        return self._params_from_sums(state, *self._sums(assignment, samples),
                                      decay_buffers=True)

    def fit(self, state: GMMState, samples: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> GMMState:
        """``kmeans_iter`` Lloyd iterations (at least one) on a sample set,
        or, when ``samples`` is None, the components from the buffers."""
        if samples is None:
            return self._params_from_sums(state, state.n_obs, state.s1, state.s2,
                                          decay_buffers=False)
        state = self._maybe_init(state, samples, generator)
        for _ in range(max(self.kmeans_iter, 1)):
            assignment = self.assign(self.params(state), samples, generator, training=True)
            state = self._params_from_sums(state, *self._sums(assignment, samples),
                                           decay_buffers=False)
        return state

    # ------------------------------------------------------------- evaluation

    @full_f32
    def predict_mean_var(self, params: GMMParams,
                         assignments: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Assignment-weighted component mean and covariance per sample."""
        mean = assignments @ params.mean  # [*L, B, D]
        if self.diag:
            return mean, assignments @ params.cov
        k, d = self.n_components, self.dim
        var = assignments @ params.cov.reshape(*params.cov.shape[:-3], k, d * d)
        return mean, var.reshape(*var.shape[:-1], d, d)

    def log_prob(self, params: GMMParams, samples: torch.Tensor) -> torch.Tensor:
        """log Σₖ wₖ N(x | μₖ, Σₖ) → [*L, B]."""
        return torch.logsumexp(self.energy(params, samples), dim=-1)

    def sample(self, params: GMMParams, generator: torch.Generator,
               batch_size: int) -> torch.Tensor:
        """Draws [*L, B, D]: a component by the weights, then its Gaussian."""
        idx = _categorical(params.weights + _EPS, generator, batch_size)  # [*L, B]
        comp = self._component_gaussian.sample(GaussianParams(params.mean, params.cov),
                                               generator, batch_size)  # [*L, K, B, D]
        picked = torch.gather(comp, -3, idx[..., None, :, None].expand(
            *idx.shape[:-1], 1, batch_size, self.dim))
        return picked[..., 0, :, :]

    def barycenter(self, params: GMMParams, assignments: torch.Tensor,
                   n_iter: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-sample W2 barycenter of the components under the assignment
        weights [*L, B, K]."""
        lead, k, d = assignments.shape[:-1], self.n_components, self.dim
        mean = params.mean[..., None, :, :].expand(*lead, k, d)
        if self.diag:
            cov = params.cov[..., None, :, :].expand(*lead, k, d)
        else:
            cov = params.cov[..., None, :, :, :].expand(*lead, k, d, d)
        return gaussian_barycenter(mean, cov, assignments, diag=self.diag, n_iter=n_iter)

    def w2(self, params: GMMParams, other: GMMParams, **sinkhorn_kwargs) -> torch.Tensor:
        """Entropic MW2 to another mixture [*L]."""
        cost, _ = batch_ot_gmm(params.mean, other.mean, params.cov, other.cov, self.diag,
                               params.weights, other.weights,
                               **{"max_iter": 100, **sinkhorn_kwargs})
        return cost

    # ------------------------------------------------------------- autograd fit

    def init_trainable(self, generator: torch.Generator) -> dict:
        """The components' trainable Gaussians and zero weight logits."""
        t = self._component_gaussian.init_trainable(generator)
        t["weight_logits"] = torch.zeros((*self.leading_shape, self.n_components),
                                         dtype=self.dtype, device=generator.device)
        return t

    def constrain(self, trainable: dict) -> GMMParams:
        g = self._component_gaussian.constrain(
            {k: trainable[k] for k in ("mean", "scale_raw")})
        return GMMParams(g.mean, g.cov, torch.softmax(trainable["weight_logits"], dim=-1))

    def nll(self, trainable: dict, samples: torch.Tensor) -> torch.Tensor:
        return -torch.mean(self.log_prob(self.constrain(trainable), samples))
