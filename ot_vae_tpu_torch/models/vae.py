"""VAE (counterpart: ``ot_vae_tpu/models/vae.py``).

``VAENet`` is encoder → prior → decoder on NHWC tensors, from an
encoder and a decoder or from one ``autoencoder`` that holds both; ``VAE``
wraps it with the inference transforms, the nELBO loss the trainer
minimises and the eval forward its validation runs. Train or eval mode
follows ``module.training``: in train mode the batch norms use and update
batch statistics.

Where no generator and no ε are given, ``forward`` and ``encode`` draw ε
from a fresh generator seeded 0 on every call, as the JAX package uses
``PRNGKey(0)`` there: two calls on one input agree.

Conditioning (``labels``, and ``time`` for a time-conditioned model)
reaches only the nets whose ``forward`` (or the autoencoder's
``encode``/``decode``) accepts it, as ``_call_net`` does in the JAX package,
and always the prior; a conditional ``VAE`` hands each batch's labels on as
``kwargs``. The train step's dropout generator (``dropout_rng``) reaches the
nets that accept one the same way, as the JAX ``loss_fn`` hands its
``dropout`` key to the nets' apply.

Subclasses extend three hooks, as in the JAX package: ``batch_preprocess``
(AutoDiffusion draws t there), ``prior_loss`` and ``_loss_aux`` (DAD's
autoregressive logits), and ``sample_fn``, the one route ``VAE.sample`` and
``InferenceEngine.sample`` take to a model's sampler.
"""
from __future__ import annotations

import inspect
import math
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ot_vae_tpu_torch.models.base import VisionModel, seeded_generator
from ot_vae_tpu_torch.utils import mean_replicated_batch, replicate_batch

__all__ = ["VAENet", "VAE"]


_ROUTED = ("labels", "time", "dropout_rng")


def _accepted(fn) -> frozenset:
    """Which of ``labels``, ``time`` and ``dropout_rng`` ``fn`` (a module's
    ``forward`` or a method) accepts."""
    target = fn.forward if isinstance(fn, nn.Module) else fn
    return frozenset(_ROUTED) & frozenset(inspect.signature(target).parameters)


def _call_net(fn, accepted: frozenset, x: torch.Tensor, **kwargs) -> torch.Tensor:
    """``fn(x)``, with each of ``kwargs`` that is given and ``fn`` accepts."""
    return fn(x, **{k: v for k, v in kwargs.items() if v is not None and k in accepted})


class VAENet(nn.Module):
    """Encoder → prior (reparametrize + loss) → decoder. Pass ``encoder`` and
    ``decoder``, or an ``autoencoder`` with ``encode`` and ``decode`` (its
    parameters then sit under ``autoencoder.``, as in the JAX tree)."""

    def __init__(self, encoder: Optional[nn.Module] = None,
                 decoder: Optional[nn.Module] = None,
                 prior: Optional[nn.Module] = None,
                 autoencoder: Optional[nn.Module] = None):
        super().__init__()
        if autoencoder is None and (encoder is None or decoder is None):
            raise ValueError("Set `autoencoder` or (`encoder` and `decoder`)")
        if autoencoder is not None and (encoder is not None or decoder is not None):
            raise ValueError("Setting both `autoencoder` and `encoder`/`decoder` is ambiguous")
        self.autoencoder = autoencoder
        self.encoder = encoder
        self.decoder = decoder
        self.prior = prior
        # which nets take labels and a dropout generator is fixed here, not
        # looked up on every call
        self._encode_accepts = _accepted(self._encode_net)
        self._decode_accepts = _accepted(self._decode_net)

    @property
    def _encode_net(self):
        return self.autoencoder.encode if self.autoencoder is not None else self.encoder

    @property
    def _decode_net(self):
        return self.autoencoder.decode if self.autoencoder is not None else self.decoder

    @property
    def latent_size(self) -> Tuple[int, ...]:
        """(H, W, C) of the latent after the prior."""
        enc_out = tuple(self.autoencoder.latent_size if self.autoencoder is not None
                        else self.encoder.out_size)
        return enc_out if self.prior is None else tuple(self.prior.out_size(enc_out))

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, expand: int = 1,
               step: Union[int, torch.Tensor] = 0, return_artifacts: bool = False,
               labels: Optional[torch.Tensor] = None,
               dropout_rng: Optional[torch.Generator] = None,
               time: Optional[torch.Tensor] = None):
        """z, or (z, per-sample prior loss, artifacts) with ``return_artifacts``.
        The batch (with ``labels`` and ``time``) is replicated ``expand``×
        before the draw."""
        return self.reparametrize(self.features(x, labels, dropout_rng, time), generator,
                                  noise, expand, step, return_artifacts, labels, time)

    def features(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                 dropout_rng: Optional[torch.Generator] = None,
                 time: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The encoder's output, before the prior."""
        return _call_net(self._encode_net, self._encode_accepts, x, labels=labels,
                         time=time, dropout_rng=dropout_rng)

    def reparametrize(self, enc: torch.Tensor, generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None, expand: int = 1,
                      step: Union[int, torch.Tensor] = 0, return_artifacts: bool = False,
                      labels: Optional[torch.Tensor] = None,
                      time: Optional[torch.Tensor] = None):
        """The prior's draw of z from the encoder's output; see ``encode``."""
        enc = replicate_batch(enc, expand)
        if self.prior is None:
            z, loss, artifacts = enc, enc.new_zeros(enc.shape[0]), {}
        else:
            if generator is None and noise is None:
                generator = seeded_generator(0, enc.device)  # JAX: PRNGKey(0)
            z, loss, artifacts = self.prior(enc, step, generator=generator, noise=noise,
                                            labels=replicate_batch(labels, expand),
                                            time=replicate_batch(time, expand))
        return (z, loss, artifacts) if return_artifacts else z

    def decode(self, z: torch.Tensor, labels: Optional[torch.Tensor] = None,
               expand: int = 1, dropout_rng: Optional[torch.Generator] = None,
               time: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _call_net(self._decode_net, self._decode_accepts, z,
                         labels=replicate_batch(labels, expand),
                         time=replicate_batch(time, expand), dropout_rng=dropout_rng)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, expand: int = 1,
                labels: Optional[torch.Tensor] = None,
                time: Optional[torch.Tensor] = None) -> torch.Tensor:
        z = self.encode(x, generator, noise, expand, labels=labels, time=time)
        return self.decode(z, labels, expand, time=time)

    def sample_latents(self, batch_size: int, generator: Optional[torch.Generator] = None,
                       labels: Optional[torch.Tensor] = None,
                       time: Optional[torch.Tensor] = None) -> torch.Tensor:
        shape = (batch_size, *self.latent_size)
        device = next(self.parameters()).device
        if self.prior is None:
            return torch.randn(shape, generator=generator, device=device)
        return self.prior.sample(shape, generator=generator, device=device, labels=labels,
                                 time=time)

    def sample(self, batch_size: int, generator: Optional[torch.Generator] = None,
               labels: Optional[torch.Tensor] = None,
               time: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decode(self.sample_latents(batch_size, generator, labels, time), labels,
                           time=time)


class VAE(VisionModel):
    """nELBO = MSE(recon, target) + prior loss, and the inference API
    (``encode``, ``decode``, ``sample``, forward), each wrapped by the
    inference transforms when ``inference`` is on.

    :param expansion: samples of z per image in the loss; the reconstruction
        term takes the mean of the replicas' reconstructions
    :param conditional: hand each batch's labels to the nets and the prior
    """

    def __init__(self, encoder: Optional[nn.Module] = None,
                 decoder: Optional[nn.Module] = None,
                 prior: Optional[nn.Module] = None, metrics=None,
                 monitor: str = "psnr", mode: str = "max", expansion: int = 1,
                 learning_rate: float = 1e-3,
                 ema_decay: Optional[float] = None, checkpoints=None,
                 gradient_clip_val: Optional[float] = None,
                 autoencoder: Optional[nn.Module] = None, conditional: bool = False):
        super().__init__(VAENet(encoder, decoder, prior, autoencoder), metrics, monitor,
                         mode, learning_rate, ema_decay, gradient_clip_val, checkpoints)
        self.expansion = expansion
        self.conditional = conditional
        self.progressive_transform = None

    @property
    def latent_size(self) -> Tuple[int, ...]:
        return self.net.latent_size

    # ------------------------------------------------------------ training

    def batch_preprocess(self, batch, train: bool = True,
                         generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """(samples, labels) → {'samples', 'target', 'kwargs'}; ``kwargs``
        holds the labels of a conditional model. A training batch first
        passes through ``progressive_transform``, the curriculum that
        :class:`ot_vae_tpu_torch.data.progressive.ProgressiveTransform` sets,
        which draws from ``generator`` (the step's preprocessing draw, the
        JAX step's ``k_pre``; the eval steps hand one too, which a plain VAE
        does not use); samples and target are both the transformed images."""
        samples, labels = batch[0], batch[1]
        if train and self.progressive_transform is not None:
            samples = self.progressive_transform(samples, generator)
        kwargs = {"labels": labels} if self.conditional else {}
        return {"samples": samples, "target": samples, "kwargs": kwargs}

    def recon_loss(self, reconstructions: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        acc = torch.promote_types(reconstructions.dtype, torch.float32)
        return torch.mean((reconstructions.to(acc) - target.to(acc)) ** 2)

    def prior_loss(self, prior_loss: torch.Tensor, prior_artifacts=None, aux=None,
                   **kwargs) -> torch.Tensor:
        """The batch's prior term from the per-sample prior loss; ``aux`` is
        what ``_loss_aux`` returned, ``kwargs`` the batch's."""
        return torch.mean(prior_loss)

    def _loss_aux(self, pbatch, z, prior_loss, prior_artifacts,
                  dropout_rng: Optional[torch.Generator] = None):
        """Extra computation in the train forward, after the decoder, handed
        to ``prior_loss`` as ``aux`` (DAD's autoregressive logits)."""
        return None

    def loss_fn(self, pbatch: Dict[str, torch.Tensor], step: Union[int, torch.Tensor] = 0,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                dropout_rng: Optional[torch.Generator] = None):
        """nELBO in train mode (batch statistics, running statistics
        updated, dropout active), as the JAX ``loss_fn`` applies the net with
        ``train=True``.

        :param noise: ε for the (expanded) batch; drawn from ``generator``
            when None
        :param dropout_rng: the dropout draws of the nets that take one (the
            JAX ``rngs["dropout"]``); a net with dropout raises without it
        :return: (loss, logs, outputs)
        """
        samples, target = pbatch["samples"], pbatch["target"]
        batch_size = samples.shape[0]
        self.net.train()
        kwargs = pbatch.get("kwargs", {})
        z, ploss, partifacts = self.net.encode(samples, generator, noise, self.expansion,
                                               step, return_artifacts=True,
                                               dropout_rng=dropout_rng, **kwargs)
        recon = self.net.decode(z, expand=self.expansion, dropout_rng=dropout_rng, **kwargs)
        aux = self._loss_aux(pbatch, z, ploss, partifacts, dropout_rng)
        recon_mean = mean_replicated_batch(recon, self.expansion)
        p_loss = (self.prior_loss(ploss, partifacts, aux=aux, **kwargs)
                  / math.prod(samples.shape[1:]))
        r_loss = self.recon_loss(recon_mean, target)
        loss = r_loss + p_loss
        logs = {"train/loss/total": loss.detach(), "train/loss/recon": r_loss.detach(),
                "train/loss/prior": p_loss.detach()}
        outputs = {**pbatch, "preds": recon[:batch_size], "latents": z[:batch_size],
                   "preds_mean": recon_mean,
                   **{k: v for k, v in partifacts.items() if isinstance(v, torch.Tensor)}}
        return loss, logs, outputs

    @torch.no_grad()
    def eval_outputs(self, pbatch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None,
                     latent_generator: Optional[torch.Generator] = None):
        """(preds, latents) of the eval step in eval mode (running
        statistics): the full forward with ε from ``generator`` and the
        latents (the JAX ``encode_fn``) with ε from ``latent_generator``,
        both drawn from one pass of the encoder."""
        self.net.eval()
        kwargs = pbatch.get("kwargs", {})
        enc = self.net.features(pbatch["samples"], **kwargs)
        preds = self.net.decode(self.net.reparametrize(enc, generator, **kwargs), **kwargs)
        return preds, self.net.reparametrize(enc, latent_generator, **kwargs)

    @torch.no_grad()
    def eval_encode(self, samples: torch.Tensor,
                    generator: Optional[torch.Generator] = None, **kwargs) -> torch.Tensor:
        """Latents in eval mode, the eval step's ``latents`` (the JAX
        ``encode_fn``); ``kwargs`` are a batch's (the labels of a conditional
        model)."""
        self.net.eval()
        return self.net.encode(samples, generator, **kwargs)

    @torch.no_grad()
    def eval_decode(self, latents: torch.Tensor, **kwargs) -> torch.Tensor:
        """Decoded latents in eval mode (the JAX ``decode_fn``)."""
        self.net.eval()
        return self.net.decode(latents, **kwargs)

    # ------------------------------------------------------------ user API

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, **kwargs) -> torch.Tensor:
        return self.net.encode(self.maybe_preprocess(x), generator, noise, **kwargs)

    def decode(self, z: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.maybe_postprocess(self.net.decode(z, **kwargs))

    def sample_fn(self, batch_size: int, generator: Optional[torch.Generator] = None,
                  **kwargs) -> torch.Tensor:
        """The model's sampler, before the inference transforms: draws from
        the prior, decoded. Subclasses put their own sampler here."""
        return self.net.sample(batch_size, generator, **kwargs)

    def sample(self, batch_size: int, generator: Optional[torch.Generator] = None,
               **kwargs) -> torch.Tensor:
        if generator is None:
            generator = self.default_generator()
        return self.maybe_postprocess(self.sample_fn(batch_size, generator, **kwargs))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, **kwargs) -> torch.Tensor:
        return self.maybe_postprocess(self.net(self.maybe_preprocess(x), generator, noise,
                                               **kwargs))
