"""DAD, the Discrete Auto Diffuser: a VAE with a codebook prior and an
autoregressive token decoder (counterpart: ``ot_vae_tpu/models/dad.py``).

The train forward also runs the autoregressive decoder on the codebook
assignment indices (``_loss_aux``), and the prior loss adds the shifted
cross-entropy between its logits and the assignment distributions (tokens
before n predict token n). Sampling is ancestral, token by token: by default
with the decoder's KV caches (one single-token call a token), or with
``kv_cache=False`` through the unrolled oracle (one full forward a token).
Both draw the initial tokens and then each step's token from one generator
in the same order, so for one generator they give the same samples.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ot_vae_tpu_torch.models.vae import VAE, VAENet, _accepted, _call_net
from ot_vae_tpu_torch.priors.codebook import CodebookPrior

__all__ = ["DADNet", "DAD", "initial_tokens", "draw_tokens"]


def initial_tokens(batch_size: int, n_tokens: int, vocab: int,
                   generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The sampler's first draw: tokens [B, n_tokens] uniform over the
    vocabulary (only the first is kept; the rest are overwritten)."""
    return torch.randint(0, vocab, (batch_size, n_tokens), generator=generator,
                         device=device)


def draw_tokens(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One categorical draw per row of ``logits`` [B, V] by the Gumbel-max
    trick, as ``jax.random.categorical`` draws."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    g = -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits.float() + g, dim=-1)


class DADNet(VAENet):
    """``VAENet`` with the autoregressive token decoder and the samplers."""

    def __init__(self, encoder=None, decoder=None, prior: Optional[CodebookPrior] = None,
                 autoencoder=None, autoregressive_decoder: Optional[nn.Module] = None):
        super().__init__(encoder, decoder, prior, autoencoder)
        self.autoregressive_decoder = autoregressive_decoder
        self._ar_accepts = _accepted(autoregressive_decoder)

    def ar_logits(self, indices: torch.Tensor, labels: Optional[torch.Tensor] = None,
                  time: Optional[torch.Tensor] = None, decode: bool = False,
                  positions: Optional[torch.Tensor] = None, caches=None,
                  dropout_rng: Optional[torch.Generator] = None):
        """Next-token logits [B, T, V] for indices [B, T]; with ``decode``,
        ``(logits, caches)`` from the decoder's KV-cached path."""
        if decode:
            return self.autoregressive_decoder(indices, decode=True, positions=positions,
                                               caches=caches)
        return _call_net(self.autoregressive_decoder, self._ar_accepts, indices,
                         labels=labels, time=time, dropout_rng=dropout_rng)

    def decode_tokens(self, tokens: torch.Tensor,
                      labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Indices [B, n_tokens] → codebook atoms → the latent → decoded."""
        prior = self.prior
        n_tokens, vocab = prior.n_tokens, prior.num_embeddings
        codebook = prior.codebook()  # [T or 1, K, D]
        atoms = codebook.expand(n_tokens, vocab, codebook.shape[-1])
        latents = atoms[torch.arange(n_tokens, device=tokens.device)[None], tokens]
        return self.decode(prior._unflatten(latents.transpose(0, 1)), labels)

    @torch.no_grad()
    def ancestral_sample(self, batch_size: int, generator: Optional[torch.Generator] = None,
                         labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The unrolled oracle: one full AR forward per generated token."""
        prior = self.prior
        device = next(self.parameters()).device
        tokens = initial_tokens(batch_size, prior.n_tokens, prior.num_embeddings,
                                generator, device)
        for i in range(prior.n_tokens - 1):
            logits = self.ar_logits(tokens, labels=labels)
            tokens[:, i + 1] = draw_tokens(logits[:, i], generator)
        return self.decode_tokens(tokens, labels)

    @torch.no_grad()
    def cached_sample(self, batch_size: int, generator: Optional[torch.Generator] = None,
                      labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The KV-cached sampler: a full-length decode call makes the zeroed
        caches (as flax's first ``decode=True`` call), then one single-token
        call a step writes its key and value and yields the next token."""
        prior = self.prior
        n_tokens = prior.n_tokens
        device = next(self.parameters()).device
        tokens = initial_tokens(batch_size, n_tokens, prior.num_embeddings, generator,
                                device)
        _, caches = self.ar_logits(tokens, labels, decode=True,
                                   positions=torch.arange(n_tokens, device=device))
        for i in range(n_tokens - 1):
            logits, caches = self.ar_logits(tokens[:, i:i + 1], labels, decode=True,
                                            positions=torch.tensor([i], device=device),
                                            caches=caches)
            tokens[:, i + 1] = draw_tokens(logits[:, 0], generator)
        return self.decode_tokens(tokens, labels)


class DAD(VAE):
    """A ``VAE`` with a :class:`CodebookPrior` and an autoregressive decoder.

    :param ce_coeff: weight of the shifted cross-entropy in the prior loss
    :param kv_cache: sample with the KV caches (else the unrolled oracle)
    """

    def __init__(self, *args, prior: CodebookPrior,
                 autoregressive_decoder: nn.Module, ce_coeff: float = 1.0,
                 kv_cache: bool = True, **kwargs):
        super().__init__(*args, prior=prior, **kwargs)
        base = self.net
        self.net = DADNet(base.encoder, base.decoder, prior, base.autoencoder,
                          autoregressive_decoder)
        self.ce_coeff = ce_coeff
        self.kv_cache = kv_cache
        self.n_tokens = prior.n_tokens
        self.num_embeddings = prior.num_embeddings

    def _loss_aux(self, pbatch, z, prior_loss, prior_artifacts,
                  dropout_rng: Optional[torch.Generator] = None):
        """The AR logits over the (detached) assignment indices, in train mode."""
        return self.net.ar_logits(prior_artifacts["indices"].detach(),
                                  labels=pbatch.get("kwargs", {}).get("labels"),
                                  dropout_rng=dropout_rng)

    def prior_loss(self, prior_loss: torch.Tensor, prior_artifacts=None, aux=None,
                   **kwargs) -> torch.Tensor:
        """mean(prior loss + ce_coeff · shifted CE(assignments ‖ AR logits))."""
        labels = prior_artifacts["distribution"].detach()  # [B, T, K]
        log_probs = torch.log_softmax(aux[:, :-1], dim=-1)
        ce = -torch.sum(labels[:, 1:] * log_probs, dim=-1).sum(-1)  # [B]
        return torch.mean(prior_loss + self.ce_coeff * ce)

    def sample_fn(self, batch_size: int, generator: Optional[torch.Generator] = None,
                  **kwargs) -> torch.Tensor:
        """Ancestral sampling: KV-cached by default, the oracle without
        ``kv_cache``."""
        sampler = self.net.cached_sample if self.kv_cache else self.net.ancestral_sample
        return sampler(batch_size, generator, labels=kwargs.get("labels"))
