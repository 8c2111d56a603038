"""VQ-VAE-style codebook prior (counterpart: ``ot_vae_tpu/priors/codebook.py``).

``embed_dims`` (1-based dims of the NHWC latent, or (tokens, dim)) choose
which dims form one vector to quantize; the others are token positions.
The latent [B, *latent_size] is permuted and flattened into
[n_tokens, B, D], assigned to a codebook of ``n_components`` atoms under
the training or inference mode, and unflattened back.

The codebook is one of two things. With ``update_with_autograd`` it is the
parameter ``atoms`` [L, K, D], learned through the soft assignments (the JAX
``params/.../codebook``). Otherwise it is the k-means state of
:class:`~ot_vae_tpu_torch.distributions.codebook.CodebookModel`, buffers of
the submodule ``kmeans`` (the JAX ``prior_stats/.../codebook``), updated by
one streaming k-means step per training forward. L is 1 (one codebook
shared by every token position, as the reference) unless
``per_token_codebook``.

The hard modes ("sample", "argmax") pass gradients to the encoder through
the straight-through estimator; the soft ones add a 0.1 commitment loss.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ot_vae_tpu_torch.distributions import codebook as _codebook
from ot_vae_tpu_torch.distributions.codebook import CodebookModel, CodebookState
from ot_vae_tpu_torch.priors.base import PriorModule
from ot_vae_tpu_torch.utils import permute_and_flatten, unflatten_and_unpermute

__all__ = ["CodebookPrior"]


class _KMeansBuffers(nn.Module):
    """The k-means state as buffers: ``codebook`` [L, K, D], ``n_obs``
    [L, K], ``s1`` [L, K, D] and ``initialized``."""

    def __init__(self, state: CodebookState):
        super().__init__()
        self.register_buffer("codebook", state.codebook)
        self.register_buffer("n_obs", state.n_obs)
        self.register_buffer("s1", state.s1)
        self.register_buffer("initialized", torch.tensor(bool(state.initialized)))

    def state(self) -> CodebookState:
        return CodebookState(self.codebook, self.n_obs, self.s1, bool(self.initialized))

    @torch.no_grad()
    def store(self, state: CodebookState):
        self.codebook.copy_(state.codebook)
        self.n_obs.copy_(state.n_obs)
        self.s1.copy_(state.s1)
        self.initialized.fill_(bool(state.initialized))


class CodebookPrior(PriorModule):
    """Discrete codebook prior over permute-flattened latent vectors.

    :param latent_size: the latent's size without the batch, e.g. (H, W, C)
    :param embed_dims: 1-based dims embedded together: (3,) embeds each
        pixel's channel vector (NHWC), (1, 2, 3) the whole tensor
    :param loss: None, "l2", "kl" or "first_kl"
    :param temperature_annealing: period (steps) of the cosine temperature
        schedule T·cos(π·step/period)/2 + 1/2
    :param update_with_autograd: the codebook is a parameter learned by
        gradient descent, not a k-means state
    :param per_token_codebook: one codebook per token position

    Forward: ``prior(x, step, generator)`` → (z, per-sample loss [B],
    artifacts ``{"distribution": [B, T, K], "indices": [B, T]}``); train or
    eval mode follows ``module.training``, and ``generator`` draws the
    sampled indices, the Gumbel noise and the k-means seeding.
    """

    def __init__(self, latent_size: Sequence[int] = (), embed_dims: Sequence[int] = (),
                 loss: Optional[str] = None, temperature_annealing: Optional[int] = None,
                 n_components: int = 256, metric: str = "euclidean", p: float = 2.0,
                 topk: Optional[int] = None, temperature: float = 1.0,
                 training_mode: str = "argmax", inference_mode: str = "argmax",
                 kmeans_decay: Optional[float] = 0.99, laplace_eps: Optional[float] = 1e-5,
                 update_with_autograd: bool = False, per_token_codebook: bool = False,
                 loss_coeff: float = 1.0, annealing_steps: int = 0):
        super().__init__(loss_coeff, annealing_steps)
        self.latent_size, self.embed_dims = tuple(latent_size), tuple(embed_dims)
        self.loss, self.temperature_annealing = loss, temperature_annealing
        self.temperature, self.training_mode = temperature, training_mode
        self.update_with_autograd = update_with_autograd
        all_dims = list(range(1, len(self.latent_size) + 1))
        if not set(self.embed_dims).issubset(all_dims):
            raise ValueError(f"`embed_dims` must be a subset of {all_dims}, "
                             f"got {self.embed_dims}")
        self.event_shape = tuple(self.latent_size[i - 1] for i in self.embed_dims)
        self.batch_shape = tuple(self.latent_size[i - 1] for i in all_dims
                                 if i not in self.embed_dims)
        self.dimensionality = math.prod(self.event_shape)
        self.num_embeddings = n_components
        self.n_tokens = math.prod(self.batch_shape)
        lead = (self.n_tokens,) if per_token_codebook and self.n_tokens > 1 else (1,)
        self._lead = lead
        self.model = CodebookModel(
            leading_shape=lead, dim=self.dimensionality, n_components=n_components,
            metric=metric, p=p, topk=topk, temperature=temperature,
            training_mode=training_mode, inference_mode=inference_mode,
            update_decay=kmeans_decay, laplace_eps=laplace_eps)
        if update_with_autograd:
            self.atoms = nn.Parameter(torch.randn(*lead, n_components, self.dimensionality))
        else:
            self.kmeans = _KMeansBuffers(self.model.init(torch.Generator().manual_seed(0)))

    @property
    def commitment_cost(self) -> float:
        return 0.0 if self.training_mode in ("sample", "argmax") else 0.1

    def out_size(self, size: Sequence[int]) -> Tuple[int, ...]:
        return tuple(size)

    def _flatten(self, x: torch.Tensor) -> torch.Tensor:
        """[B, *latent_size] → [n_tokens, B, D]."""
        return permute_and_flatten(x, self.embed_dims, batch_first=False, flatten_batch=False)

    def _unflatten(self, xr: torch.Tensor) -> torch.Tensor:
        return unflatten_and_unpermute(xr, (-1, *self.latent_size), self.embed_dims,
                                       batch_first=False, flatten_batch=False)

    def _current_state(self) -> CodebookState:
        if self.update_with_autograd:
            w = self.atoms
            return CodebookState(codebook=w, n_obs=w.new_ones(w.shape[:-1]),
                                 s1=torch.zeros_like(w), initialized=True)
        return self.kmeans.state()

    def _compute_loss(self, x: torch.Tensor, encodings: torch.Tensor,
                      probs: torch.Tensor) -> torch.Tensor:
        """Per-sample prior loss; x and encodings [T, B, D], probs [T, B, K]."""
        kind = None if self.loss is None else self.loss.lower()
        if kind is None:
            prior_loss = x.new_zeros(x.shape[-2])
        elif kind == "l2":
            prior_loss = torch.mean((x - encodings.detach()) ** 2, dim=-1).sum(0)
        elif kind in ("kl", "first_kl"):
            entropy = -torch.sum(probs * torch.log(probs + 1e-8), dim=-1)  # [T, B]
            kl = float(math.log(self.num_embeddings)) - entropy
            prior_loss = kl[0] if kind == "first_kl" else kl.sum(0)
        else:
            raise NotImplementedError(f"loss={self.loss}")
        if self.commitment_cost > 0:
            embed_loss = torch.mean((encodings - x.detach()) ** 2, dim=-1).sum(0)
            prior_loss = prior_loss + self.commitment_cost * embed_loss
        return prior_loss

    def temperature_at(self, step: Union[int, torch.Tensor]) -> Optional[torch.Tensor]:
        """The annealed temperature at ``step``, or None without annealing."""
        if self.temperature_annealing is None:
            return None
        s = torch.as_tensor(step, dtype=torch.float32)
        return (self.temperature * 0.5 * torch.cos(math.pi * s / self.temperature_annealing)
                + 0.5)

    def forward(self, x: torch.Tensor, step: Union[int, torch.Tensor] = 0,
                generator: Optional[torch.Generator] = None, noise=None, **_):
        xf = self._flatten(x)  # [n_tokens, B, D]
        state = self._current_state()
        temp = self.temperature_at(step)
        if temp is not None:
            temp = temp.to(x.device)
        if self.training and not self.update_with_autograd:
            xu = xf.detach()
            if self._lead == (1,) and xu.shape[0] != 1:
                # a shared codebook: every token position updates the one codebook
                xu = xu.reshape(1, -1, xu.shape[-1])
            with torch.no_grad():
                state = self.model.update(state, xu, generator)
            self.kmeans.store(state)
        encodings, assignment = self.model.predict(state, xf, generator,
                                                   training=self.training, temperature=temp)
        prior_loss = self.scale_loss(self._compute_loss(xf, encodings, assignment.probs), step)
        if self.training_mode in ("sample", "argmax"):
            encodings = xf + (encodings - xf).detach()  # straight-through
        artifacts = {"distribution": assignment.probs.transpose(0, 1),
                     "indices": assignment.indices.transpose(0, 1)}
        return self._unflatten(encodings), prior_loss, artifacts

    def sample(self, shape: Sequence[int], generator: Optional[torch.Generator] = None,
               device=None, **_) -> torch.Tensor:
        """Codebook atoms drawn for every (token, batch) slot by the mixture
        weights, from the one shared categorical when the codebook is
        shared, reassembled into [B, *latent_size]."""
        state = self._current_state()
        batch_size, n = shape[0], max(self.n_tokens, 1)
        if self._lead == (1,) and n > 1:
            weights = self.model.weights(state)[0] + _codebook._EPS  # [K]
            idx = _codebook._categorical(weights.expand(n, -1), generator, batch_size)
            draws = state.codebook[0][idx]  # [T, B, D]
        else:
            draws = self.model.sample(state, generator, batch_size)
        return self._unflatten(draws)

    def codebook(self) -> torch.Tensor:
        """The codebook [L, K, D]."""
        return self._current_state().codebook
