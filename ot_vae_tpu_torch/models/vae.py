"""VAE for serving (counterpart: ``ot_vae_tpu/models/vae.py``).

``VAENet`` is encoder → prior → decoder on NHWC tensors; ``VAE`` wraps it
with the inference transforms. The nELBO loss and training come with the
training slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ot_vae_tpu_torch.models.base import VisionModel
from ot_vae_tpu_torch.utils import replicate_batch

__all__ = ["VAENet", "VAE"]


class VAENet(nn.Module):
    """Encoder → prior (reparametrize) → decoder, eval mode."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 prior: Optional[nn.Module] = None):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.prior = prior

    @property
    def latent_size(self) -> Tuple[int, ...]:
        """(H, W, C) of the latent after the prior."""
        enc_out = tuple(self.encoder.out_size)
        return enc_out if self.prior is None else tuple(self.prior.out_size(enc_out))

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, expand: int = 1) -> torch.Tensor:
        enc = replicate_batch(self.encoder(x), expand)
        if self.prior is None:
            return enc
        return self.prior(enc, generator=generator, noise=noise)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, expand: int = 1) -> torch.Tensor:
        return self.decode(self.encode(x, generator, noise, expand))

    def sample_latents(self, batch_size: int,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        shape = (batch_size, *self.latent_size)
        device = next(self.parameters()).device
        if self.prior is None:
            return torch.randn(shape, generator=generator, device=device)
        return self.prior.sample(shape, generator=generator, device=device)

    def sample(self, batch_size: int,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.decode(self.sample_latents(batch_size, generator))


class VAE(VisionModel):
    """Inference API of the VAE: ``encode``, ``decode``, ``sample`` and the
    eval-mode forward, each wrapped by the inference transforms when
    ``inference`` is on."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 prior: Optional[nn.Module] = None):
        super().__init__(VAENet(encoder, decoder, prior))

    @property
    def latent_size(self) -> Tuple[int, ...]:
        return self.net.latent_size

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.net.encode(self.maybe_preprocess(x), generator, noise)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.maybe_postprocess(self.net.decode(z))

    def sample(self, batch_size: int,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None:
            generator = self.default_generator()
        return self.maybe_postprocess(self.net.sample(batch_size, generator))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.maybe_postprocess(self.net(self.maybe_preprocess(x), generator, noise))
