"""LatentTransport callback: fit a latent-space transport operator online
during training (counterpart: ``ot_vae_tpu/transport/callback.py``).

During validation, clean latents feed the target distribution (even
batches) and the latents of degraded images the source (odd batches,
unpaired); at the epoch's end the operator is fitted, and its cost and a
six-panel collage of the first validation batch are logged; at test time
degraded latents are transported, decoded, and the restored images scored
with the model's cloned test metrics. ``transport_dims`` are
1-based dims of the NHWC latent [B, H, W, C]: (3,) transports each pixel's
channel vector, (1, 2) each channel's spatial map, (1, 2, 3) the whole
tensor.

Random draws come from the callback's own ``torch.Generator`` (seeded with
``seed`` on the trainer's device); a caller of :meth:`transport` may pass
its own, and then the callback's stream is not touched. A conditional
model's labels reach its encoder and decoder from each batch's ``kwargs``.
The per-class callback (``class_idx``) arrives with slice 4c (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ot_vae_tpu_torch.trainer.callbacks import Callback, list_to_collage
from ot_vae_tpu_torch.utils import (
    camel2snake,
    permute_and_flatten,
    resolve_device,
    unflatten_and_unpermute,
)

__all__ = ["LatentTransport"]

_STRUCTURE_KEY = "__structure__"


@dataclasses.dataclass(eq=False)
class LatentTransport(Callback):
    """:param size: latent size without the batch, NHWC (H, W, C)
    :param transport_dims: 1-based dims of [B, *size] transported together
    :param transport_operator: an operator class, built here with the leading
        and event shapes that ``transport_dims`` give, plus ``operator_kwargs``
    :param transformations: the degradation, ``t(images, generator)``
    :param common_operator: one operator for all positions, else one each
    :param num_samples_to_log: images in each row of the collage logged at
        every validation's end (0: none)
    :param device: where the operator state lives until a fit puts it on
        the trainer's device (:meth:`load_state` reads onto it)
    """

    size: Tuple[int, ...] = ()
    transport_dims: Tuple[int, ...] = ()
    transport_operator: type = None
    transformations: Callable = None
    common_operator: bool = False
    unpaired: bool = True
    source_latents_from_train: bool = False
    target_latents_from_train: bool = False
    store_source: bool = False
    store_target: bool = False
    logging_prefix: Optional[str] = None
    num_samples_to_log: int = 8
    class_idx: Optional[int] = None
    operator_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    seed: int = 0
    device: Any = "cuda"

    def __post_init__(self):
        if self.class_idx is not None:
            raise NotImplementedError(
                "class_idx: ConditionalLatentTransport arrives with slice 4c (ROADMAP)")
        all_dims = list(range(1, len(self.size) + 1))
        if not set(self.transport_dims).issubset(all_dims):
            raise ValueError(f"`transport_dims` must be a subset of {all_dims}")
        batch_dims = sorted(set(all_dims).difference(self.transport_dims))
        self.batch_shape = tuple(self.size[i - 1] for i in batch_dims)
        self.event_shape = tuple(self.size[i - 1] for i in self.transport_dims)
        self.dim = math.prod(self.event_shape)
        leading = () if self.common_operator else (math.prod(self.batch_shape),)
        self.operator = self.transport_operator(
            leading_shape=leading, dim=self.dim, store_source=self.store_source,
            store_target=self.store_target, **self.operator_kwargs)
        flatten_batch = self.common_operator and len(self.size) > len(self.transport_dims)
        self._flatten = functools.partial(
            permute_and_flatten, permute_dims=self.transport_dims,
            batch_first=self.common_operator, flatten_batch=flatten_batch)
        self._unflatten = functools.partial(
            unflatten_and_unpermute, orig_shape=(-1, *self.size),
            permute_dims=self.transport_dims, batch_first=self.common_operator,
            flatten_batch=flatten_batch)
        op_name = camel2snake(type(self.operator).__name__).replace("_transport", "")
        suffix = f"/{self.logging_prefix}" if self.logging_prefix else ""
        self.logging_prefix_full = f"transport/{op_name}{suffix}/"

        self.state = None
        self.test_metrics = None
        self._test_metric_states = None
        self._stored: Dict[str, list] = {"source": [], "target": []}
        self._generator = None
        self._last_cost = None

    # ------------------------------------------------------------ helpers

    def _gen(self) -> torch.Generator:
        """The callback's own generator, on its device, seeded at first use."""
        device = resolve_device(self.device)
        if self._generator is None or self._generator.device != device:
            self._generator = torch.Generator(device=device).manual_seed(self.seed)
        return self._generator

    def _update(self, latents: torch.Tensor, source: bool):
        flat = self._flatten(latents)
        side = "source" if source else "target"
        if self.store_source if source else self.store_target:
            self._stored[side].append(flat)
        self.state = self.operator.update(
            self.state, source_samples=flat if source else None,
            target_samples=None if source else flat, generator=self._gen())

    def _encode(self, model, samples: torch.Tensor, kwargs) -> torch.Tensor:
        return model.eval_encode(samples, self._gen(), **kwargs)

    def transport(self, latents: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Flatten → operator → unflatten. With ``generator`` the draw comes
        from it and the callback's own stream is left as it was."""
        flat = self._flatten(latents)
        moved = self.operator.transport(self.state, flat,
                                        self._gen() if generator is None else generator)
        return self._unflatten(moved)

    # ------------------------------------------------------- state persistence

    def save_state(self, path) -> None:
        """Write the (fitted) operator state to an ``.npz`` file: one array
        per leaf by name, and the names and shapes of the leaves."""
        if self.state is None:
            raise ValueError("no operator state to save: call init or fit first")
        arrays = self.state.to_arrays()
        structure = repr(sorted((k, v.shape, str(v.dtype)) for k, v in arrays.items()))
        np.savez(path, **{_STRUCTURE_KEY: np.asarray(structure)}, **arrays)

    def load_state(self, path) -> "LatentTransport":
        """Read a state written by :meth:`save_state` onto ``device``. Its
        structure must be that of a fresh state of this callback's operator,
        so a file of another configuration fails loudly."""
        path = str(path)
        data = np.load(path if path.endswith(".npz") else f"{path}.npz")
        template = self.operator.init(torch.Generator().manual_seed(0))
        want = template.to_arrays()
        expected = repr(sorted((k, v.shape, str(v.dtype)) for k, v in want.items()))
        saved = str(data[_STRUCTURE_KEY])
        if saved != expected:
            raise ValueError("saved operator state structure does not match this "
                             f"callback's operator:\n  saved: {saved}\n  expected: {expected}")
        arrays = {k: data[k] for k in data.files if k != _STRUCTURE_KEY}
        self.state = type(template).from_arrays(arrays, template,
                                                device=resolve_device(self.device))
        return self

    # ------------------------------------------------------------ hooks

    def on_fit_start(self, trainer, model):
        self.device = trainer.device
        if model.test_metrics is not None:
            self.test_metrics = model.test_metrics.clone(self.logging_prefix_full)
        self.state = self.operator.init(self._gen())

    def on_train_batch_end(self, trainer, model, outputs, batch, batch_idx):
        if not (self.target_latents_from_train or self.source_latents_from_train):
            return
        if self.target_latents_from_train and (
                not self.unpaired or not self.source_latents_from_train or batch_idx % 2 == 0):
            latents = outputs.get("latents")
            if latents is None:
                latents = self._encode(model, outputs["samples"], outputs.get("kwargs", {}))
            self._update(latents.detach(), source=False)
        if self.source_latents_from_train and (
                not self.unpaired or not self.target_latents_from_train or batch_idx % 2 == 1):
            degraded = self.transformations(outputs["samples"].detach(), self._gen())
            self._update(self._encode(model, degraded, outputs.get("kwargs", {})), source=True)

    def on_validation_epoch_start(self, trainer, model):
        if self.state is None:
            self.state = self.operator.init(self._gen())
        self.state = self.operator.reset(self.state, self._gen())
        self._stored = {"source": [], "target": []}

    def on_validation_batch_end(self, trainer, model, outputs, batch, batch_idx):
        """Even batches → target, odd → source (unpaired)."""
        if not self.target_latents_from_train and (
                not self.unpaired or self.source_latents_from_train or batch_idx % 2 == 0):
            latents = outputs.get("latents")
            if latents is None:
                latents = self._encode(model, outputs["samples"], outputs.get("kwargs", {}))
            self._update(latents, source=False)
        if not self.source_latents_from_train and (
                not self.unpaired or self.target_latents_from_train or batch_idx % 2 == 1):
            degraded = self.transformations(outputs["samples"], self._gen())
            self._update(self._encode(model, degraded, outputs.get("kwargs", {})), source=True)

    def on_validation_epoch_end(self, trainer, model):
        """Fit the operator, log its cost and the collage."""
        stored = {side: torch.cat(v, dim=-2) if v else None
                  for side, v in self._stored.items()}
        self.state, cost = self.operator.compute(self.state, stored["source"],
                                                 stored["target"], generator=self._gen())
        self._last_cost = float(torch.mean(cost))
        name = self.logging_prefix_full + "avg_transport_cost"
        trainer.logged_metrics[name] = self._last_cost
        trainer.logger.log_metrics({name: self._last_cost}, trainer.global_step)
        self._log_images(trainer, model)

    def on_test_epoch_start(self, trainer, model):
        if self.test_metrics is not None:
            self._test_metric_states = self.test_metrics.init(resolve_device(self.device))

    @torch.no_grad()
    def on_test_batch_end(self, trainer, model, outputs, batch, batch_idx):
        """Transport the degraded latents and score the restored images."""
        if self._test_metric_states is None or self.state is None:
            return
        samples, kwargs = outputs["samples"], outputs.get("kwargs", {})
        degraded = self.transformations(samples, self._gen())
        restored = model.eval_decode(self.transport(self._encode(model, degraded, kwargs)),
                                     **kwargs)
        self._test_metric_states = self.test_metrics.update(
            self._test_metric_states, preds=restored, target=samples)

    def on_test_epoch_end(self, trainer, model):
        results = self.compute_test_metrics()
        if results:
            trainer.logged_metrics.update(results)
            trainer.logger.log_metrics(results, trainer.global_step)

    def compute_test_metrics(self) -> Dict[str, float]:
        if self._test_metric_states is None:
            return {}
        return {k: float(v)
                for k, v in self.test_metrics.compute(self._test_metric_states).items()}

    def sample(self, batch_size: int, from_dist: str = "source") -> torch.Tensor:
        """Latents drawn from the fitted source or target model."""
        n = batch_size * math.prod(self.batch_shape) if (
            self.common_operator and len(self.batch_shape) > 0) else batch_size
        draws = self.operator.sample(self.state, self._gen(), n,
                                     source=(from_dist == "source"))
        return self._unflatten(draws)

    # ------------------------------------------------------------ collage

    @torch.no_grad()
    def _log_images(self, trainer, model):
        """Six rows of ``num_samples_to_log`` images from the first
        validation batch: decoded source draws, the degraded images, their
        reconstructions, their transported reconstructions, the clean images
        and decoded target draws. Any failure raises."""
        batch = trainer.first_val_batch
        if self.num_samples_to_log <= 0 or batch is None:
            return
        device = resolve_device(self.device)
        images, labels = batch
        pbatch = model.batch_preprocess(
            (torch.as_tensor(np.asarray(images, np.float32), device=device),
             torch.as_tensor(np.asarray(labels), device=device)), train=False)
        samples, kwargs = pbatch["samples"], pbatch["kwargs"]
        n = samples.shape[0]
        transformed = self.transformations(samples, self._gen())
        latents = self._encode(model, transformed, kwargs)
        panels = [model.eval_decode(self.sample(n, "source"), **kwargs), transformed,
                  model.eval_decode(latents, **kwargs),
                  model.eval_decode(self.transport(latents), **kwargs), samples,
                  model.eval_decode(self.sample(n, "target"), **kwargs)]
        grid = list_to_collage([p.float().cpu().numpy() for p in panels],
                               min(n, self.num_samples_to_log))
        self._save(trainer, grid)

    def _save(self, trainer, grid: np.ndarray):
        """To the logger's ``log_image`` where it has one, else a PNG under
        ``collages/`` in the working directory (skipped without PIL)."""
        if hasattr(trainer.logger, "log_image"):
            trainer.logger.log_image(self.logging_prefix_full, grid, trainer.global_step)
            return
        try:
            from PIL import Image
        except ImportError:
            return
        out = Path("collages")
        out.mkdir(exist_ok=True)
        arr = (np.clip(grid, 0, 1) * 255).astype(np.uint8)
        if arr.shape[-1] == 1:
            arr = arr[..., 0]
        name = self.logging_prefix_full.replace("/", "_")
        Image.fromarray(arr).save(out / f"{name}epoch{trainer.current_epoch}.png")
