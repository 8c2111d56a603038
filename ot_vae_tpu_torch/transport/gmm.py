"""GMM (mixture-coupling) transport (counterpart: ``ot_vae_tpu/transport/gmm.py``).

``compute`` fits both mixtures and couples their components by entropic
OT (:func:`ot_vae_tpu_torch.ops.w2.batch_ot_gmm`, the plain Sinkhorn: this
path has no TPU kernel); ``transport`` assigns each sample to a source
component, routes it through the coupling to a target component (its
largest entry, a draw, or the barycenter of the components) and moves it
with that pair's Gaussian operators.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ot_vae_tpu_torch.distributions.gmm import GMMModel, GMMState
from ot_vae_tpu_torch.ops.matrix import full_f32
from ot_vae_tpu_torch.ops.w2 import apply_transport, batch_ot_gmm, compute_transport_operators
from ot_vae_tpu_torch.transport.base import OperatorState, TransportOperator

__all__ = ["GMMTransport", "GMMTransportState"]

_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class GMMTransportState(OperatorState):
    source: GMMState
    target: GMMState
    plan: torch.Tensor  # [*L, K, K]
    fitted: bool


@dataclasses.dataclass(frozen=True)
class GMMTransport(TransportOperator):
    """:param transport_type: "argmax" | "sample" | "barycenter", how a
        sample's row of the coupling picks its target
    :param method: the spectral pipeline of the full-covariance paths
    """

    n_components: int = 16
    transport_type: str = "argmax"
    diag: bool = True
    stochastic: bool = False
    pg_star: float = 0.0
    make_pd: bool = True
    temperature: float = 1.0
    topk: Optional[int] = None
    training_mode: str = "argmax"
    inference_mode: str = "argmax"
    kmeans_iter: int = 100
    update_decay: Optional[float] = None
    sinkhorn_max_iter: int = 100
    dtype: torch.dtype = torch.float32
    method: str = "auto"

    @property
    def source_model(self) -> GMMModel:
        return GMMModel(
            leading_shape=self.leading_shape, dim=self.dim, n_components=self.n_components,
            diag=self.diag, topk=self.topk, temperature=self.temperature,
            training_mode=self.training_mode, inference_mode=self.inference_mode,
            kmeans_iter=self.kmeans_iter, update_decay=self.update_decay, dtype=self.dtype)

    target_model = source_model

    def init(self, generator: torch.Generator) -> GMMTransportState:
        m, k = self.source_model, self.n_components
        return GMMTransportState(
            source=m.init(generator), target=m.init(generator),
            plan=torch.zeros((*self.leading_shape, k, k), dtype=self.dtype,
                             device=generator.device),
            fitted=False)

    def update(self, state, source_samples=None, target_samples=None, generator=None,
               sample_weights=None):
        m = self.source_model
        if source_samples is not None:
            state = state.replace(source=m.update(state.source, source_samples, generator,
                                                  sample_weights))
        if target_samples is not None:
            state = state.replace(target=m.update(state.target, target_samples, generator,
                                                  sample_weights))
        return state

    @full_f32
    def compute(self, state, source_samples=None, target_samples=None, generator=None):
        """Fit both mixtures and couple their components: (state, MW2 [*L])."""
        m = self.source_model
        source = m.fit(state.source, source_samples, generator)
        target = m.fit(state.target, target_samples, generator)
        ps, pt = m.params(source), m.params(target)
        total_cost, coupling = batch_ot_gmm(ps.mean, pt.mean, ps.cov, pt.cov, self.diag,
                                            ps.weights, pt.weights, method=self.method,
                                            max_iter=self.sinkhorn_max_iter)
        return state.replace(source=source, target=target, plan=coupling.to(self.dtype),
                             fitted=True), total_cost

    @full_f32
    def transport(self, state, inputs: torch.Tensor, generator=None) -> torch.Tensor:
        """Move samples [*L, B, D]; "sample" routing and eq. 19's noise draw
        from ``generator``."""
        m = self.source_model
        ps, pt = m.params(state.source), m.params(state.target)
        assignments = m.assign(ps, inputs, generator, training=False).weights
        source_means, source_vars = m.predict_mean_var(ps, assignments)
        target_assignments = assignments @ state.plan  # [*L, B, K]
        if self.transport_type in ("sample", "argmax"):
            if self.transport_type == "argmax":
                idx = torch.argmax(target_assignments, dim=-1)
            else:
                if generator is None:
                    raise ValueError("transport_type='sample' requires a generator")
                flat = (target_assignments + _EPS).reshape(-1, self.n_components)
                idx = torch.multinomial(flat, 1, generator=generator).reshape(
                    target_assignments.shape[:-1])
            one_hot = torch.nn.functional.one_hot(idx, self.n_components).to(
                target_assignments.dtype)
            target_means, target_vars = m.predict_mean_var(pt, one_hot)
        elif self.transport_type == "barycenter":
            w = target_assignments / torch.clamp_min(
                target_assignments.sum(-1, keepdim=True), _EPS)
            target_means, target_vars = m.barycenter(pt, w, n_iter=100)
        else:
            raise NotImplementedError(self.transport_type)
        T, Cw = compute_transport_operators(source_vars, target_vars,
                                            stochastic=self.stochastic, diag=self.diag,
                                            pg_star=self.pg_star, make_pd=self.make_pd,
                                            method=self.method)
        return apply_transport(inputs, source_means, target_means, T,
                               Cw if self.stochastic else None, diag=self.diag,
                               generator=generator, method=self.method).to(inputs.dtype)

    def sample(self, state, generator: torch.Generator, batch_size: int,
               source: bool = True) -> torch.Tensor:
        m = self.source_model
        return m.sample(m.params(state.source if source else state.target), generator,
                        batch_size)
