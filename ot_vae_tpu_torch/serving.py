"""Serving: batched inference over a VAE (counterpart: ``ot_vae_tpu/serving.py``).

Requests are padded up to the nearest batch bucket, so the card sees a few
fixed shapes; raw images are normalised and outputs un-normalised with the
model's inference transforms. Every endpoint runs under
``torch.inference_mode()`` and takes conditioning kwargs (``labels``) for a
conditional model; batch-shaped ones are padded with zeros to the bucket
alongside the images. ``restore`` serves latent-transport
restoration: encode degraded images, transport their latents through a
fitted ``LatentTransport``, decode.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ot_vae_tpu_torch.models.base import seeded_generator
from ot_vae_tpu_torch.trainer.checkpoint import load_checkpoint
from ot_vae_tpu_torch.utils import resolve_device

__all__ = ["InferenceEngine"]


class InferenceEngine:
    """Bucketed inference over a model whose weights are already loaded.

    :param model: a ``VAE``; its weights come from ``checkpoint_path`` when
        given, else they are the model's own (``convert.load_jax_variables``
        or a seeded init)
    :param checkpoint_path: a checkpoint directory written by
        ``trainer.checkpoint.save_checkpoint``: the net's state dict and the
        inference transforms of its sidecar
    :param batch_sizes: batch buckets; a request is padded up to the nearest
    :param use_ema: serve the checkpoint's EMA parameters, where it has them
    :param device: the engine's device; ``"cuda"`` raises without a card
    """

    def __init__(self, model, checkpoint_path: Optional[str] = None,
                 batch_sizes: Sequence[int] = (1, 8, 64), use_ema: bool = False,
                 mesh=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "mesh: multi-GPU serving arrives with the multi-GPU slice")
        self.device = resolve_device(device)
        if checkpoint_path is not None:
            tree, _ = load_checkpoint(checkpoint_path, model)
            if use_ema and tree.get("ema_params") is not None:
                model.net.load_state_dict({**tree["model"], **tree["ema_params"]},
                                          strict=True)
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        self.model.inference = True
        self.batch_sizes = tuple(sorted(batch_sizes))
        # when a caller passes no generator, every endpoint draws from a
        # per-engine counter: a fresh engine reproduces the same sequence
        self._default_calls = 0

    def _default_generator(self) -> torch.Generator:
        g = seeded_generator(self._default_calls, self.device)
        self._default_calls += 1
        return g

    def _bucket(self, n: int) -> int:
        bucket = next((b for b in self.batch_sizes if b >= n), None)
        if bucket is None:
            top = self.batch_sizes[-1]
            bucket = -(-n // top) * top
        return bucket

    def _pad(self, x: torch.Tensor, bucket: int) -> torch.Tensor:
        n = x.shape[0]
        if n < bucket:
            x = torch.cat([x, x.new_zeros((bucket - n, *x.shape[1:]))])
        return x

    def _images(self, images) -> Tuple[torch.Tensor, int]:
        x = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        n = x.shape[0]
        return self._pad(self.model.inference_preprocess(x), self._bucket(n)), n

    def _kwargs(self, kwargs, n: int, bucket: int):
        """Conditioning kwargs on the engine's device; arrays with the
        request's batch are padded with zeros up to the bucket (the JAX
        engine's ``_prep_kwargs``)."""
        out = {}
        for name, value in kwargs.items():
            value = torch.as_tensor(np.asarray(value), device=self.device)
            if value.dim() >= 1 and value.shape[0] == n:
                value = self._pad(value, bucket)
            out[name] = value
        return out

    def _noise(self, noise, bucket: int) -> Optional[torch.Tensor]:
        if noise is None:
            return None
        eps = torch.as_tensor(np.asarray(noise, np.float32), device=self.device)
        return self._pad(eps, bucket)

    @staticmethod
    def _out(x: torch.Tensor, n: int) -> np.ndarray:
        return x[:n].float().cpu().numpy()

    # ------------------------------------------------------------ serving API

    @torch.inference_mode()
    def encode(self, images, generator: Optional[torch.Generator] = None,
               noise=None, **kwargs) -> np.ndarray:
        """Raw NHWC images → latents z = μ + σ·ε. ``noise`` is ε for the
        request's rows; without it ε is drawn from ``generator``."""
        x, n = self._images(images)
        generator = generator if generator is not None else self._default_generator()
        z = self.model.net.encode(x, generator, self._noise(noise, x.shape[0]),
                                  **self._kwargs(kwargs, n, x.shape[0]))
        return self._out(z, n)

    @torch.inference_mode()
    def decode(self, latents, **kwargs) -> np.ndarray:
        z = torch.as_tensor(np.asarray(latents, np.float32), device=self.device)
        n = z.shape[0]
        bucket = self._bucket(n)
        out = self.model.net.decode(self._pad(z, bucket), **self._kwargs(kwargs, n, bucket))
        return self._out(self.model.inference_postprocess(out), n)

    @torch.inference_mode()
    def sample(self, batch_size: int, generator: Optional[torch.Generator] = None,
               **kwargs) -> np.ndarray:
        """``batch_size`` samples through the model's sampler
        (``model.sample_fn``: prior draws decoded for a plain VAE), not
        bucketed, as in the JAX engine; ``labels`` [batch_size] for a
        conditional model."""
        generator = generator if generator is not None else self._default_generator()
        out = self.model.sample_fn(batch_size, generator,
                                   **self._kwargs(kwargs, batch_size, batch_size))
        return self._out(self.model.inference_postprocess(out), batch_size)

    @torch.inference_mode()
    def reconstruct(self, images, generator: Optional[torch.Generator] = None,
                    noise=None, **kwargs) -> np.ndarray:
        x, n = self._images(images)
        generator = generator if generator is not None else self._default_generator()
        out = self.model.net(x, generator, self._noise(noise, x.shape[0]),
                             **self._kwargs(kwargs, n, x.shape[0]))
        return self._out(self.model.inference_postprocess(out), n)

    @torch.inference_mode()
    def restore(self, images, transport, generator: Optional[torch.Generator] = None,
                **kwargs) -> np.ndarray:
        """Restoration: encode raw degraded images (padded to the bucket),
        flatten, transport and unflatten their latents through a fitted
        ``LatentTransport`` (in this process, or read with its
        ``load_state``), decode. The request's ``generator`` (else the
        engine's default draw) serves the encoder's ε and then the
        transport's draw; the callback's own generator is not touched."""
        if transport.state is None:
            raise ValueError(
                "transport has no fitted state — fit it during training or "
                "load one with LatentTransport.load_state()")
        x, n = self._images(images)
        generator = generator if generator is not None else self._default_generator()
        kwargs = self._kwargs(kwargs, n, x.shape[0])
        z = self.model.net.encode(x, generator, **kwargs)
        out = self.model.net.decode(transport.transport(z, generator), **kwargs)
        return self._out(self.model.inference_postprocess(out), n)
