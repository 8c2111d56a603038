"""Gaussian (Monge-map) transport operator (counterpart:
``ot_vae_tpu/transport/gaussian.py``): the affine map T·(x − μs) + μt
between two Gaussians fitted from streaming moments, with the operators of
eq. 17/19 of the distortion-perception paper
(:func:`ot_vae_tpu_torch.ops.w2.compute_transport_operators`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ot_vae_tpu_torch.distributions.gaussian import GaussianModel, GaussianParams, GaussianState
from ot_vae_tpu_torch.ops.matrix import full_f32, trace
from ot_vae_tpu_torch.ops.w2 import apply_transport, compute_transport_operators, w2_gaussian
from ot_vae_tpu_torch.transport.base import OperatorState, TransportOperator

__all__ = ["GaussianTransport", "GaussianTransportState"]


def _shrink(cov: torch.Tensor, shrinkage: float, diag: bool) -> torch.Tensor:
    """(1 − λ)·Σ + λ·(tr Σ / D)·I, shrinkage towards the mean variance."""
    if diag:
        return (1.0 - shrinkage) * cov + shrinkage * cov.mean(-1, keepdim=True)
    d = cov.shape[-1]
    mean_var = trace(cov)[..., None, None] / d
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    return (1.0 - shrinkage) * cov + shrinkage * mean_var * eye


@dataclasses.dataclass(frozen=True)
class GaussianTransportState(OperatorState):
    source: GaussianState
    target: GaussianState
    mean_source: torch.Tensor  # [*L, D]
    mean_target: torch.Tensor  # [*L, D]
    T: torch.Tensor  # [*L, D, D] ([*L, D] when diag)
    Cw: torch.Tensor  # as T
    fitted: bool


@dataclasses.dataclass(frozen=True)
class GaussianTransport(TransportOperator):
    """:param stochastic: eq. 19's operator and noise, else eq. 17's
    :param pg_star: perception-distortion ratio in [0, 1]
    :param make_pd: shift both covariances to PSD before the operator
    :param shrinkage: trace-scaled diagonal loading of both covariances;
        with fewer samples than dimensions the empirical covariance is
        rank-deficient, and the Monge map would amplify its null space
    :param compensated: Kahan-compensated f32 sums (plain sums only)
    :param method: the spectral pipeline, "eigh" | "polar" | "auto" (eigh)
    """

    diag: bool = False
    stochastic: bool = False
    pg_star: float = 0.0
    make_pd: bool = True
    update_decay: Optional[float] = None
    shrinkage: float = 1e-3
    compensated: bool = True
    dtype: torch.dtype = torch.float32
    method: str = "auto"

    @property
    def source_model(self) -> GaussianModel:
        return GaussianModel(self.leading_shape, self.dim, diag=self.diag,
                             update_decay=self.update_decay, dtype=self.dtype,
                             compensated=self.compensated and self.update_decay is None)

    target_model = source_model

    def init(self, generator: torch.Generator) -> GaussianTransportState:
        """Zero sums and operators on the generator's device (nothing is
        drawn)."""
        m, device = self.source_model, generator.device
        L, D = self.leading_shape, self.dim
        op_shape = (*L, D) if self.diag else (*L, D, D)
        return GaussianTransportState(
            source=m.init(device), target=m.init(device),
            mean_source=torch.zeros((*L, D), dtype=self.dtype, device=device),
            mean_target=torch.zeros((*L, D), dtype=self.dtype, device=device),
            T=torch.zeros(op_shape, dtype=self.dtype, device=device),
            Cw=torch.zeros(op_shape, dtype=self.dtype, device=device), fitted=False)

    def update(self, state, source_samples=None, target_samples=None, generator=None,
               sample_weights=None):
        m = self.source_model
        if source_samples is not None:
            state = state.replace(source=m.update(state.source, source_samples,
                                                  sample_weights))
        if target_samples is not None:
            state = state.replace(target=m.update(state.target, target_samples,
                                                  sample_weights))
        return state

    def _fit(self, side: GaussianState, samples=None) -> GaussianParams:
        params = self.source_model.fit(side, samples)
        if self.shrinkage > 0:
            params = GaussianParams(params.mean, _shrink(params.cov, self.shrinkage, self.diag))
        return params

    @full_f32
    def compute(self, state, source_samples=None, target_samples=None, generator=None):
        """Fit both Gaussians: (state with the operator, W2² [*L])."""
        ps, pt = self._fit(state.source, source_samples), self._fit(state.target, target_samples)
        if self.diag:
            cov_s, cov_t = torch.diag_embed(ps.cov), torch.diag_embed(pt.cov)
        else:
            cov_s, cov_t = ps.cov, pt.cov
        w2 = w2_gaussian(ps.mean, pt.mean, cov_s, cov_t, make_pd=self.make_pd,
                         method=self.method)
        T, Cw = compute_transport_operators(ps.cov, pt.cov, stochastic=self.stochastic,
                                            diag=self.diag, pg_star=self.pg_star,
                                            make_pd=self.make_pd, method=self.method)
        return state.replace(mean_source=ps.mean, mean_target=pt.mean, T=T, Cw=Cw,
                             fitted=True), w2

    @full_f32
    def transport(self, state, inputs: torch.Tensor, generator=None) -> torch.Tensor:
        """Map ``inputs`` [*L, D], or [*L, B, D] with a batch dim the
        operators broadcast over; eq. 19's noise is drawn from ``generator``."""
        batched = inputs.dim() == len(self.leading_shape) + 2

        def expand(x, mat=False):
            if not batched:
                return x
            return x.unsqueeze(-2 if self.diag or not mat else -3)

        return apply_transport(
            inputs, expand(state.mean_source), expand(state.mean_target),
            expand(state.T, mat=True), expand(state.Cw, mat=True) if self.stochastic else None,
            diag=self.diag, generator=generator, method=self.method)

    def sample(self, state, generator: torch.Generator, batch_size: int,
               source: bool = True) -> torch.Tensor:
        """Draws [*L, B, D] from the fitted source or target Gaussian."""
        params = self._fit(state.source if source else state.target)
        return self.source_model.sample(params, generator, batch_size)
