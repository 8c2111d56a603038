"""AutoDiffusion: a time-conditioned denoising VAE
(counterpart: ``ot_vae_tpu/models/auto_diffusion.py``).

Each batch gets a time t ~ U[0, 1] per image (``batch_preprocess``, from
the step's preprocessing generator; 0.5 without one), the nets and the
prior are conditioned on it, and the prior loss is weighted by
β_t = tanh(10(t − 0.5))/2 + 1/2. The sampler (``diffusion_sample``, the
model's ``sample_fn``) decodes and re-encodes ``n_steps`` times as t runs
from 1 down to 1/n_steps.

The collage methods ``reconstruction`` and ``generation`` arrive with the
``Collage`` callback.
"""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ot_vae_tpu_torch.models.vae import VAE, VAENet
from ot_vae_tpu_torch.utils import replicate_batch

__all__ = ["AutoDiffusionNet", "AutoDiffusion", "standard_normal"]


def standard_normal(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """ε ~ N(0, 1) of ``shape`` from ``generator``: the sampler's draw of
    each step's noise (the counterpart of the JAX sampler's
    ``jax.random.normal``)."""
    return torch.randn(tuple(shape), generator=generator, device=device)


class AutoDiffusionNet(VAENet):
    """``VAENet`` with the iterative diffusion sampler."""

    def __init__(self, encoder=None, decoder=None, prior=None, autoencoder=None,
                 n_steps: int = 10):
        super().__init__(encoder, decoder, prior, autoencoder)
        self.n_steps = n_steps

    @torch.no_grad()
    def diffusion_sample(self, batch_size: int, generator: Optional[torch.Generator] = None,
                         labels: Optional[torch.Tensor] = None,
                         improved_algorithm: bool = False, return_steps: bool = False,
                         ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """Latents from the prior at t = 1, then for each s in
        linspace(1, 1/n, n): x̂ = decode(z, t=s) and z = encode(x̂, t=s − 1/n)
        (the improved algorithm: z − (encode(x̂, s − 1/n) − encode(x̂, s)),
        both encodes with the step's one ε). The initial latents come from
        the prior, each step's ε from :func:`standard_normal`, all from
        ``generator`` in that order.

        :return: the last x̂, or every step's with ``return_steps``
        """
        device = next(self.parameters()).device
        ones = torch.ones(batch_size, device=device)
        xs = self.sample_latents(batch_size, generator, labels, time=ones)
        step_size = 1.0 / self.n_steps
        x_hat, intermediate = None, []
        for s in np.linspace(1.0, step_size, self.n_steps):
            x_hat = self.decode(xs, labels, time=ones * float(s))
            eps = standard_normal((batch_size, *self.latent_size), generator, device)
            t_next = ones * float(s - step_size)
            if improved_algorithm:
                xs = xs - (self.encode(x_hat, noise=eps, labels=labels, time=t_next)
                           - self.encode(x_hat, noise=eps, labels=labels,
                                         time=ones * float(s)))
            else:
                xs = self.encode(x_hat, noise=eps, labels=labels, time=t_next)
            if return_steps:
                intermediate.append(x_hat)
        return intermediate if return_steps else x_hat


class AutoDiffusion(VAE):
    """A ``VAE`` whose batches carry a time t; ``n_steps`` sampler steps."""

    def __init__(self, *args, n_steps: int = 10, **kwargs):
        super().__init__(*args, **kwargs)
        base = self.net
        self.net = AutoDiffusionNet(base.encoder, base.decoder, base.prior, base.autoencoder,
                                    n_steps=n_steps)
        self.n_steps = n_steps

    def batch_preprocess(self, batch, train: bool = True,
                         generator: Optional[torch.Generator] = None):
        """Adds ``time`` t ~ U[0, 1) per image from ``generator`` (in train
        and eval steps alike, as the JAX steps hand their ``k_pre``), 0.5
        without one."""
        pbatch = super().batch_preprocess(batch, train, generator)
        samples = pbatch["samples"]
        if generator is None:
            t = torch.full((samples.shape[0],), 0.5, device=samples.device)
        else:
            t = torch.rand(samples.shape[0], generator=generator, device=samples.device)
        pbatch["kwargs"] = {**pbatch["kwargs"], "time": t}
        return pbatch

    def prior_loss(self, prior_loss: torch.Tensor, prior_artifacts=None, aux=None,
                   **kwargs) -> torch.Tensor:
        """mean(β_t · prior loss), β_t = 0.5·tanh(10(t − 0.5)) + 0.5."""
        t = replicate_batch(kwargs["time"], self.expansion)
        beta_t = 0.5 * torch.tanh(10.0 * (t - 0.5)) + 0.5
        return torch.mean(beta_t * prior_loss)

    def sample_fn(self, batch_size: int, generator: Optional[torch.Generator] = None,
                  **kwargs) -> torch.Tensor:
        """The diffusion sampler (standard algorithm)."""
        return self.net.diffusion_sample(batch_size, generator, labels=kwargs.get("labels"))
