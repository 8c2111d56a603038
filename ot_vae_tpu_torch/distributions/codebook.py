"""Discrete codebook (VQ dictionary) fit by streaming k-means
(counterpart: ``ot_vae_tpu/distributions/codebook.py``).

A :class:`CodebookModel` is a frozen config with functions over a
:class:`CodebookState` of tensors, as in the JAX package; the first batch a
state sees seeds its codebook by farthest-point (k-means++-style) seeding.
Random draws take a ``torch.Generator`` where the JAX package takes a key:
the two give different numbers, so tests carry states across instead.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ot_vae_tpu_torch.ops.w2 import sinkhorn_log
from ot_vae_tpu_torch.utils import ema, laplace_smoothing

__all__ = ["CodebookState", "CodebookModel", "Assignment", "assign_from_energy",
           "gumbel_noise", "kmeanspp_init"]

_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class CodebookState:
    codebook: torch.Tensor  # [*L, K, D]
    n_obs: torch.Tensor  # [*L, K]
    s1: torch.Tensor  # [*L, K, D]
    initialized: bool

    def replace(self, **changes) -> "CodebookState":
        return dataclasses.replace(self, **changes)


class Assignment(NamedTuple):
    weights: torch.Tensor  # [*L, B, K] the mode's assignment weights
    indices: torch.Tensor  # [*L, B] sampled (with a generator) or argmax indices
    probs: torch.Tensor  # [*L, B, K] softmax assignment distribution


def _categorical(probs: torch.Tensor, generator: Optional[torch.Generator],
                 n: Optional[int] = None) -> torch.Tensor:
    """Indices drawn ∝ ``probs`` over the last dim: [*] (or [*, n])."""
    flat = probs.reshape(-1, probs.shape[-1])
    idx = torch.multinomial(flat, n or 1, replacement=True, generator=generator)
    return idx.reshape(*probs.shape[:-1], n) if n else idx.reshape(probs.shape[:-1])


def gumbel_noise(shape, generator: torch.Generator, device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard Gumbel draws −log(−log U), U uniform in [tiny, 1), as
    ``jax.random.gumbel`` draws them; the one Gumbel draw of the assignment
    modes."""
    u = torch.rand(tuple(shape), generator=generator, device=device, dtype=dtype)
    return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(dtype).tiny)))


def assign_from_energy(energy: torch.Tensor, mode: str, n_components: int,
                       temperature: float = 1.0, topk: Optional[int] = None,
                       generator: Optional[torch.Generator] = None) -> Assignment:
    """Assignment weights from an energy [*L, B, K] under ``mode``: "mean"
    (the softmax), "argmax" or "sample" (one-hot), "gumbel-softmax" (the
    softmax of the energy plus Gumbel noise, at ``temperature``) or
    "gumbel-hardmax" (its one-hot forward with the soft gradient: the
    straight-through estimator). ``generator`` draws the indices, then the
    Gumbel noise; the Gumbel modes need it."""
    if topk is not None and topk > 0:
        kth = torch.sort(energy, dim=-1).values[..., -topk][..., None]
        energy = torch.where(energy >= kth, energy, torch.full_like(energy, -torch.inf))
    probs = torch.softmax(energy / temperature, dim=-1)
    if generator is not None:
        indices = _categorical(probs + _EPS, generator)
    else:
        indices = torch.argmax(probs, dim=-1)

    def one_hot(idx):
        return torch.nn.functional.one_hot(idx, n_components).to(probs.dtype)

    if mode == "mean" or topk == 1:
        weights = probs
    elif mode == "sample":
        weights = one_hot(indices)
    elif mode == "argmax":
        weights = one_hot(torch.argmax(probs, dim=-1))
    elif "gumbel" in mode:
        if generator is None:
            raise ValueError("gumbel assignment modes require a generator")
        g = gumbel_noise(energy.shape, generator, energy.device, probs.dtype)
        soft = torch.softmax((energy + g) / temperature, dim=-1)
        if "hard" in mode:
            hard = one_hot(torch.argmax(soft, dim=-1))
            weights = soft + (hard - soft).detach()  # hard forward, soft gradient
        else:
            weights = soft
    else:
        raise NotImplementedError(f"assignment mode={mode}")
    return Assignment(weights, indices, probs)


def kmeanspp_init(samples: torch.Tensor, k: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Farthest-point seeding: the first center is a random sample, each
    next one the sample farthest from the chosen set.

    :param samples: [*L, B, D]
    :return: centers [*L, k, D]
    """
    *lead, n, d = samples.shape
    centers = samples.new_zeros((*lead, k, d))
    min_d2 = None
    for i in range(k):
        if i == 0:
            idx = torch.randint(0, n, tuple(lead), generator=generator,
                                device=samples.device)
        else:
            idx = torch.argmax(min_d2, dim=-1)
        center = torch.gather(samples, -2, idx[..., None, None].expand(*lead, 1, d))
        centers[..., i, :] = center[..., 0, :]
        d2 = torch.sum((samples - center) ** 2, dim=-1)  # [*L, B]
        min_d2 = d2 if min_d2 is None else torch.minimum(min_d2, d2)
    return centers


@dataclasses.dataclass(frozen=True)
class CodebookModel:
    """Static config and pure state transforms of a discrete codebook:
    metric euclidean or cosine with power ``p``, optional top-k masking,
    temperature, per-phase assignment modes, mini-batch k-means with an EMA
    and Laplace smoothing."""

    leading_shape: Tuple[int, ...] = ()
    dim: int = 1
    n_components: int = 16
    metric: str = "euclidean"
    p: float = 2.0
    topk: Optional[int] = None
    temperature: float = 1.0
    training_mode: str = "argmax"
    inference_mode: str = "argmax"
    kmeans_iter: int = 100
    laplace_eps: Optional[float] = 1e-5
    update_decay: Optional[float] = None
    dtype: torch.dtype = torch.float32

    # ------------------------------------------------------------- state

    def init(self, generator: torch.Generator) -> CodebookState:
        """A random codebook on the generator's device, no observations."""
        shape, device = (*self.leading_shape, self.n_components), generator.device
        return CodebookState(
            codebook=torch.randn((*shape, self.dim), generator=generator, device=device,
                                 dtype=self.dtype),
            n_obs=torch.zeros(shape, device=device, dtype=self.dtype),
            s1=torch.zeros((*shape, self.dim), device=device, dtype=self.dtype),
            initialized=False)

    def weights(self, state: CodebookState) -> torch.Tensor:
        """Mixture weights from the observation counts; uniform before any."""
        total = state.n_obs.sum(dim=-1, keepdim=True)
        uniform = torch.full_like(state.n_obs, 1.0 / self.n_components)
        return torch.where(total > _EPS, state.n_obs / torch.clamp_min(total, _EPS), uniform)

    # ------------------------------------------------------------- energy/assign

    def energy(self, codebook: torch.Tensor, samples: torch.Tensor) -> torch.Tensor:
        """Similarity of samples [*L, B, D] to the components → [*L, B, K]."""
        x = samples.to(codebook.dtype)
        if self.metric == "euclidean":
            if self.p == 2.0:
                sq = (torch.sum(x ** 2, dim=-1, keepdim=True)
                      + torch.sum(codebook ** 2, dim=-1)[..., None, :]
                      - 2.0 * x @ codebook.transpose(-1, -2))
                cdist = torch.sqrt(torch.clamp_min(sq, 0.0))
            else:
                diff = (x[..., :, None, :] - codebook[..., None, :, :]).abs()
                cdist = torch.sum(diff ** self.p, dim=-1) ** (1.0 / self.p)
            return 1.0 / (cdist + _EPS)
        if self.metric == "cosine":
            norm_x = torch.sum(x.abs() ** self.p, dim=-1, keepdim=True)
            norm_c = torch.sum(codebook.abs() ** self.p, dim=-1)[..., None, :]
            dot = (x @ codebook.transpose(-1, -2)).abs()
            return dot / (norm_x * norm_c + _EPS) ** (1.0 / self.p)
        raise NotImplementedError(f"metric={self.metric}")

    def assign(self, codebook: torch.Tensor, samples: torch.Tensor,
               generator: Optional[torch.Generator] = None, training: bool = True,
               temperature=None) -> Assignment:
        """Assign samples under the training or inference mode; ``generator``
        draws the sampled indices (and is needed by the "sample" mode)."""
        mode = self.training_mode if training else self.inference_mode
        return assign_from_energy(
            self.energy(codebook, samples), mode, self.n_components,
            self.temperature if temperature is None else temperature, self.topk, generator)

    # ------------------------------------------------------------- k-means

    def _kmeans_sums(self, assignment: Assignment, samples: torch.Tensor):
        w = assignment.weights
        return w.sum(dim=-2), w.transpose(-1, -2) @ samples.to(w.dtype)

    def _maybe_init(self, state: CodebookState, samples: torch.Tensor,
                    generator: Optional[torch.Generator]) -> CodebookState:
        """Farthest-point seeding on the first batch a state sees."""
        if state.initialized:
            return state
        seeds = torch.broadcast_to(samples.to(self.dtype),
                                   (*self.leading_shape, *samples.shape[-2:]))
        return state.replace(codebook=kmeanspp_init(seeds, self.n_components, generator),
                             n_obs=state.n_obs + 1.0, initialized=True)

    def update(self, state: CodebookState, samples: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               sample_weights: Optional[torch.Tensor] = None) -> CodebookState:
        """One streaming k-means step on a batch [*L, B, D];
        ``sample_weights`` [*L, B] down-weights samples. Single process: the
        cross-device sum of the JAX package arrives with multi-GPU (slice 9)."""
        state = self._maybe_init(state, samples, generator)
        assignment = self.assign(state.codebook, samples, generator, training=True)
        weights = assignment.weights
        if sample_weights is not None:
            weights = weights * sample_weights[..., None]
        w_sum, s1 = self._kmeans_sums(assignment._replace(weights=weights), samples)
        hit = w_sum > _EPS
        d = self.update_decay
        n_obs = torch.where(hit, ema(state.n_obs, w_sum, d), state.n_obs)
        s1_new = torch.where(hit[..., None], ema(state.s1, s1, d), state.s1)
        denom = laplace_smoothing(n_obs, self.n_components, self.laplace_eps)
        codebook = torch.where(hit[..., None], s1_new / denom[..., None], state.codebook)
        return state.replace(codebook=codebook, n_obs=n_obs, s1=s1_new)

    def fit(self, state: CodebookState, samples: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> CodebookState:
        """``kmeans_iter`` Lloyd iterations (at least one) on a sample set, or,
        when ``samples`` is None, the codebook from the streaming sums."""
        if samples is None:
            hit = state.n_obs > _EPS
            denom = laplace_smoothing(state.n_obs, self.n_components, self.laplace_eps)
            return state.replace(codebook=torch.where(
                hit[..., None], state.s1 / denom[..., None], state.codebook))
        state = self._maybe_init(state, samples, generator)
        for _ in range(max(self.kmeans_iter, 1)):
            assignment = self.assign(state.codebook, samples, generator, training=True)
            w_sum, s1 = self._kmeans_sums(assignment, samples)
            hit = w_sum > _EPS
            denom = laplace_smoothing(w_sum, self.n_components, self.laplace_eps)
            state = state.replace(
                codebook=torch.where(hit[..., None], s1 / denom[..., None], state.codebook),
                n_obs=torch.where(hit, w_sum, state.n_obs),
                s1=torch.where(hit[..., None], s1, state.s1))
        return state

    # ------------------------------------------------------------- evaluation

    def predict(self, state: CodebookState, samples: torch.Tensor,
                generator: Optional[torch.Generator] = None, training: bool = True,
                temperature=None):
        """(assignment-weighted codebook vectors, assignment)."""
        assignment = self.assign(state.codebook, samples, generator, training, temperature)
        return assignment.weights @ state.codebook, assignment

    def sample(self, state: CodebookState, generator: torch.Generator,
               batch_size: int) -> torch.Tensor:
        """Codebook vectors [*L, B, D] drawn by the mixture weights."""
        idx = _categorical(self.weights(state) + _EPS, generator, batch_size)
        return torch.gather(state.codebook, -2,
                            idx[..., None].expand(*idx.shape, state.codebook.shape[-1]))

    def w2(self, state: CodebookState, other: CodebookState) -> torch.Tensor:
        """Sinkhorn OT cost between two codebooks [*L] (the plain batch path,
        :func:`ot_vae_tpu_torch.ops.w2.sinkhorn_log`)."""
        cost = 1.0 / (self.energy(other.codebook, state.codebook) + _EPS)
        plan = sinkhorn_log(self.weights(state), self.weights(other), cost,
                            reg=1e-5, max_iter=100, threshold=1e-3)
        return torch.sum(cost * plan, dim=(-2, -1))
