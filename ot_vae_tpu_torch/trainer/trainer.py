"""The training loop (counterpart: ``ot_vae_tpu/trainer/trainer.py``).

``fit`` runs epochs of train steps, validates with the model's metrics,
drives ReduceLROnPlateau on the monitored metric, and calls the callbacks
at the same hook points as the JAX trainer; ``validate``, ``test`` and
``predict`` run the eval loops on their own. A train step is: nELBO and its
gradients (the batch norms in train mode), optional global-norm clipping,
Adam, the EMA update and the step counter.

Random draws come from ``torch.Generator`` objects seeded from
``(seed, salt, epoch, batch_idx)``: a train step takes one each for ε,
dropout and the batch's preprocessing, the counterpart of the JAX step's
three-way key split; an eval step one each for its forward's ε, its
latents' ε and the batch's preprocessing (the JAX eval step's ``k_fwd``,
``k_enc`` and ``k_pre``: AutoDiffusion draws its t there). They are not the JAX trainer's draws, so
:meth:`Trainer.train_step` also takes ε as a tensor.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ot_vae_tpu_torch.data.transforms import Identity
from ot_vae_tpu_torch.models.base import clip_by_global_norm
from ot_vae_tpu_torch.trainer.callbacks import Callback
from ot_vae_tpu_torch.trainer.loggers import PrintLogger
from ot_vae_tpu_torch.trainer.state import TrainState
from ot_vae_tpu_torch.utils import resolve_device

__all__ = ["Trainer"]


class Trainer:
    """
    :param lr_plateau: ReduceLROnPlateau on ``val/metrics/<model.monitor>``:
        after more than ``lr_patience`` validations without an improvement
        of ``lr_threshold``, lr ← max(lr·``lr_factor``, ``min_lr``)
    :param limit_batches: cap on the batches of every train and eval epoch
    :param check_val_every_n_epoch: validate every N-th epoch and the last
    :param device: ``"cuda"`` (raises without a card) or ``"cpu"``
    """

    def __init__(
        self,
        max_epochs: int = 100,
        callbacks: Optional[List[Callback]] = None,
        logger=None,
        seed: int = 42,
        mesh=None,
        log_every_n_steps: int = 50,
        lr_plateau: bool = True,
        lr_factor: float = 0.75,
        lr_patience: int = 8,
        lr_threshold: float = 1e-1,
        min_lr: float = 1e-6,
        limit_batches: Optional[int] = None,
        profile_dir: Optional[str] = None,
        accumulate_grad_batches: int = 1,
        check_val_every_n_epoch: int = 1,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError("mesh: multi-GPU training arrives with slice 9")
        if accumulate_grad_batches > 1:
            raise NotImplementedError(
                "accumulate_grad_batches > 1 arrives with slice 9")
        if profile_dir is not None:
            raise NotImplementedError("profile_dir: profiling arrives with slice 9")
        self.device = resolve_device(device)
        self.max_epochs = max_epochs
        self.callbacks = list(callbacks or [])
        self.logger = logger or PrintLogger()
        self.seed = seed
        self.log_every_n_steps = log_every_n_steps
        self.lr_plateau = lr_plateau
        self.lr_factor = lr_factor
        self.lr_patience = lr_patience
        self.lr_threshold = lr_threshold
        self.min_lr = min_lr
        self.limit_batches = limit_batches
        self.check_val_every_n_epoch = max(1, int(check_val_every_n_epoch))

        self.state: Optional[TrainState] = None
        self.current_epoch = 0
        self.global_step = 0
        self.should_stop = False
        self.logged_metrics: Dict[str, float] = {}
        self.first_val_batch = None
        self.monitor = None

    # ------------------------------------------------------------ utilities

    def _hook(self, name: str, *args):
        for cb in self.callbacks:
            getattr(cb, name)(self, *args)

    def generator(self, *salts: int) -> torch.Generator:
        """A generator on the trainer's device seeded from (seed, *salts)."""
        seed = np.random.SeedSequence([self.seed, *(int(s) for s in salts)])
        g = torch.Generator(device=self.device)
        return g.manual_seed(int(seed.generate_state(1, np.uint64)[0] >> 1))

    def _put(self, batch):
        images, labels = batch
        return (torch.as_tensor(np.asarray(images, np.float32), device=self.device),
                torch.as_tensor(np.asarray(labels), device=self.device))

    def _set_lr(self, lr: float):
        self._lr = lr
        for group in self.state.optimizer.param_groups:
            group["lr"] = lr

    # ------------------------------------------------------------ init

    def setup_fit(self, model, datamodule):
        """Move the model to the device and build the optimizer and state;
        ``fit`` calls it, and a caller driving :meth:`train_step` itself
        calls it first."""
        self.monitor = "val/metrics/" + model.monitor
        self._monitor_mode = model.mode
        if isinstance(model.inference_preprocess, Identity):
            model.inference_preprocess = datamodule.inference_preprocess
        if isinstance(model.inference_postprocess, Identity):
            model.inference_postprocess = datamodule.inference_postprocess
        model.to(self.device, memory_format=torch.channels_last)
        self.state = TrainState.create(model.net, model.optimizer(), model.ema_decay)
        self._lr = float(model.learning_rate)
        self._plateau_best = None
        self._plateau_count = 0

    # ------------------------------------------------------------ train

    def step_generators(self, epoch: int, batch_idx: int):
        """The train step's generators of ε, dropout and preprocessing (the
        JAX step's ``k_prior``, ``k_drop`` and ``k_pre``)."""
        return tuple(self.generator(salt, epoch, batch_idx) for salt in (1, 4, 5))

    def train_step(self, model, batch, generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None,
                   dropout_rng: Optional[torch.Generator] = None,
                   preprocess_rng: Optional[torch.Generator] = None):
        """One optimizer step on ``batch`` = (images, labels) as numpy arrays.

        :param noise: ε of the prior's draw; drawn from ``generator`` when None
        :param dropout_rng: the dropout draws (a model with dropout raises
            without it)
        :param preprocess_rng: the batch preprocessing's draws
        :return: (logs, outputs) as tensors on the device; the gradients stay
            in the parameters' ``.grad`` until the next step
        """
        state = self.state
        pbatch = model.batch_preprocess(self._put(batch), train=True, generator=preprocess_rng)
        if noise is not None:
            noise = torch.as_tensor(noise, device=self.device)
        state.optimizer.zero_grad(set_to_none=True)
        loss, logs, outputs = model.loss_fn(pbatch, state.step, generator, noise, dropout_rng)
        loss.backward()
        if model.gradient_clip_val:
            clip_by_global_norm([p.grad for p in state.net.parameters()],
                                float(model.gradient_clip_val))
        state.optimizer.step()
        if model.ema_decay is not None:
            state.update_ema(model.ema_decay)
        state.step += 1
        self.global_step += 1
        return logs, outputs

    def fit(self, model, datamodule, resume_from=None):
        if resume_from is not None:
            raise NotImplementedError("resume_from: resuming a fit arrives with slice 9")
        self.setup_fit(model, datamodule)
        self._hook("on_fit_start", model)
        for epoch in range(self.max_epochs):
            if self.should_stop:
                break
            self.current_epoch = epoch
            model.inference = False
            self._hook("on_train_epoch_start", model)
            self._run_train_epoch(model, datamodule, epoch)
            self._hook("on_train_epoch_end", model)
            if ((epoch + 1) % self.check_val_every_n_epoch == 0
                    or epoch == self.max_epochs - 1):
                self._run_validation(model, datamodule)
                self._maybe_reduce_lr()
        self._hook("on_fit_end", model)
        return self

    def _run_train_epoch(self, model, datamodule, epoch):
        t0 = time.perf_counter()
        n = 0
        for batch_idx, batch in enumerate(datamodule.train_batches(epoch)):
            if self.limit_batches is not None and batch_idx >= self.limit_batches:
                break
            prior_rng, dropout_rng, preprocess_rng = self.step_generators(epoch, batch_idx)
            logs, outputs = self.train_step(model, batch, prior_rng, dropout_rng=dropout_rng,
                                            preprocess_rng=preprocess_rng)
            n += 1
            if batch_idx % self.log_every_n_steps == 0:
                self.logger.log_metrics({k: float(v) for k, v in logs.items()},
                                        self.global_step)
            self._hook("on_train_batch_end", model, outputs, batch, batch_idx)
        dt = time.perf_counter() - t0
        if n:
            print(f"epoch {epoch}: {n} steps in {dt:.1f}s "
                  f"({n * datamodule.train_batch_size / dt:.1f} img/s)", flush=True)

    # ------------------------------------------------------------ evaluation

    def _run_eval_loop(self, model, batches, metrics, mode: str, use_ema: bool):
        """One pass over ``batches`` in eval mode (the EMA parameters swapped
        in with ``use_ema``): the eval step's outputs go to the callbacks and
        the metrics, which are computed, logged and kept in
        ``logged_metrics``. ``mode`` is "val" or "test"."""
        hook = "validation" if mode == "val" else "test"
        prev_inference = model.inference
        model.inference = True
        states = metrics.init(self.device) if metrics is not None else None
        self._hook(f"on_{hook}_epoch_start", model)
        swap = self.state.ema_swapped() if use_ema else contextlib.nullcontext()
        first_batch = None
        with swap:
            for batch_idx, batch in enumerate(batches):
                if self.limit_batches is not None and batch_idx >= self.limit_batches:
                    break
                if first_batch is None:
                    first_batch = batch
                salt = 2 if mode == "val" else 3
                pbatch = model.batch_preprocess(
                    self._put(batch), train=False,
                    generator=self.generator(salt, self.current_epoch, batch_idx, 2))
                preds, latents = model.eval_outputs(
                    pbatch, self.generator(salt, self.current_epoch, batch_idx),
                    self.generator(salt, self.current_epoch, batch_idx, 1))
                outputs = {**pbatch, "preds": preds, "latents": latents}
                if states is not None:
                    states = metrics.update(states, **outputs)
                self._hook(f"on_{hook}_batch_end", model, outputs, batch, batch_idx)
        if mode == "val":
            self.first_val_batch = first_batch
        results = {}
        if states is not None:
            results = {k: float(v) for k, v in metrics.compute(states).items()}
            self.logged_metrics.update(results)
            self.logger.log_metrics(results, self.global_step)
        self._hook(f"on_{hook}_epoch_end", model)
        model.inference = prev_inference
        return results

    def _run_validation(self, model, datamodule):
        if model.val_metrics is None and not self.callbacks:
            return {}
        return self._run_eval_loop(model, datamodule.val_batches(), model.val_metrics,
                                   "val", model.ema_decay is not None)

    def _adopt_model(self, model):
        """Eval without a fit: move the model to the device and wrap it in a
        state (no EMA copy)."""
        if self.state is None:
            model.to(self.device, memory_format=torch.channels_last)
            self.state = TrainState.create(model.net, model.optimizer(), None)
            if self.monitor is None:
                self.monitor = "val/metrics/" + model.monitor

    def validate(self, model, datamodule):
        """One validation pass; the metrics by name."""
        self._adopt_model(model)
        return self._run_validation(model, datamodule)

    def test(self, model, datamodule):
        """One pass over the test split with the model's ``test_metrics``
        and the callbacks' test hooks; the metrics by name."""
        self._adopt_model(model)
        use_ema = model.ema_decay is not None and self.state.ema_params is not None
        return self._run_eval_loop(model, datamodule.test_batches(), model.test_metrics,
                                   "test", use_ema)

    @torch.no_grad()
    def predict(self, model, datamodule) -> List[torch.Tensor]:
        """The model's forward (inference transforms applied, ε from the
        fixed default draw) on each predict batch with its ``kwargs``, in
        eval mode. The batch is preprocessed without a generator, as the JAX
        ``predict`` passes no key (AutoDiffusion's t is then 0.5)."""
        self._adopt_model(model)
        prev_inference = model.inference
        model.inference = True
        model.net.eval()
        outs = []
        for batch in datamodule.predict_batches():
            pbatch = model.batch_preprocess(self._put(batch), train=False)
            outs.append(model(pbatch["samples"], **pbatch["kwargs"]))
        model.inference = prev_inference
        return outs

    # ------------------------------------------------------------ LR plateau

    def _maybe_reduce_lr(self):
        """ReduceLROnPlateau(factor, patience, threshold) on the monitor."""
        if not self.lr_plateau or self.monitor not in self.logged_metrics:
            return
        value = self.logged_metrics[self.monitor]
        sign = 1.0 if self._monitor_mode == "max" else -1.0
        if self._plateau_best is None or sign * (value - self._plateau_best) > self.lr_threshold:
            self._plateau_best = value
            self._plateau_count = 0
            return
        self._plateau_count += 1
        if self._plateau_count > self.lr_patience and self._lr > self.min_lr:
            self._set_lr(max(self._lr * self.lr_factor, self.min_lr))
            self._plateau_count = 0
            print(f"ReduceLROnPlateau: lr -> {self._lr:.2e}", flush=True)
