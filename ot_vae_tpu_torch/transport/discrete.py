"""Discrete (codebook ↔ codebook) Sinkhorn transport
(counterpart: ``ot_vae_tpu/transport/discrete.py``).

``compute`` fits the two codebooks and solves one entropic OT problem per
operator between them through :func:`ot_vae_tpu_torch.ops.sinkhorn.sinkhorn_log_auto`:
the hand-written CUDA kernel on the card, its plain version on the CPU.
That is the only Sinkhorn launch of the latent-transport path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ot_vae_tpu_torch.distributions.codebook import CodebookModel, CodebookState
from ot_vae_tpu_torch.ops.sinkhorn import sinkhorn_log_auto
from ot_vae_tpu_torch.transport.base import OperatorState, TransportOperator

__all__ = ["DiscreteTransport", "DiscreteTransportState"]

_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class DiscreteTransportState(OperatorState):
    source: CodebookState
    target: CodebookState
    plan: torch.Tensor  # [*L, K, K]
    fitted: bool


@dataclasses.dataclass(frozen=True)
class DiscreteTransport(TransportOperator):
    """Sinkhorn plan between two streaming-fit codebooks; a sample goes
    through its assignment × plan × the target codebook."""

    n_components: int = 256
    transport_type: str = "mean"  # 'mean' | 'argmax' | 'sample'
    metric: str = "euclidean"
    p: float = 2.0
    temperature: float = 1.0
    training_mode: str = "argmax"
    inference_mode: str = "argmax"
    topk: Optional[int] = None
    kmeans_iter: int = 100
    update_decay: Optional[float] = None
    sinkhorn_reg: float = 1e-5
    sinkhorn_max_iter: int = 1000
    sinkhorn_threshold: float = 1e-6
    dtype: torch.dtype = torch.float32

    @property
    def source_model(self) -> CodebookModel:
        return CodebookModel(
            leading_shape=self.leading_shape, dim=self.dim,
            n_components=self.n_components, metric=self.metric, p=self.p,
            topk=self.topk, temperature=self.temperature,
            training_mode=self.training_mode, inference_mode=self.inference_mode,
            kmeans_iter=self.kmeans_iter, update_decay=self.update_decay, dtype=self.dtype)

    target_model = source_model

    def init(self, generator: torch.Generator) -> DiscreteTransportState:
        m, k = self.source_model, self.n_components
        return DiscreteTransportState(
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

    def compute(self, state, source_samples=None, target_samples=None, generator=None):
        m = self.source_model
        source = m.fit(state.source, source_samples, generator)
        target = m.fit(state.target, target_samples, generator)
        # cost[i, j] between source atom i and target atom j
        cost = 1.0 / (m.energy(target.codebook, source.codebook) + _EPS)
        plan = sinkhorn_log_auto(m.weights(source), m.weights(target), cost,
                                 reg=self.sinkhorn_reg, max_iter=self.sinkhorn_max_iter,
                                 threshold=self.sinkhorn_threshold)
        total_cost = torch.sum(cost * plan, dim=(-2, -1))
        state = state.replace(source=source, target=target, plan=plan.to(self.dtype),
                              fitted=True)
        return state, total_cost

    def transport(self, state, inputs: torch.Tensor, generator=None) -> torch.Tensor:
        """Eval-mode assignment of ``inputs`` [*L, B, D] routed through the
        plan: its mean ("mean"), its largest entry ("argmax") or a draw
        ("sample", which needs ``generator``), row-normalised, times the
        target codebook."""
        m = self.source_model
        assignment = m.assign(state.source.codebook, inputs, generator, training=False)
        target = assignment.weights @ state.plan  # [*L, B, K]
        if self.transport_type == "argmax":
            target = torch.nn.functional.one_hot(
                torch.argmax(target, dim=-1), self.n_components).to(target.dtype)
        elif self.transport_type == "sample":
            if generator is None:
                raise ValueError("transport_type='sample' requires a generator")
            flat = (target + _EPS).reshape(-1, self.n_components)
            idx = torch.multinomial(flat, 1, generator=generator).reshape(target.shape[:-1])
            target = torch.nn.functional.one_hot(idx, self.n_components).to(target.dtype)
        elif self.transport_type != "mean":
            raise NotImplementedError(self.transport_type)
        target = target / torch.clamp_min(target.sum(dim=-1, keepdim=True), _EPS)
        return (target @ state.target.codebook).to(inputs.dtype)

    def sample(self, state, generator: torch.Generator, batch_size: int,
               source: bool = True) -> torch.Tensor:
        return self.source_model.sample(state.source if source else state.target,
                                        generator, batch_size)
