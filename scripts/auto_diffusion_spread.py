#!/usr/bin/env python3
"""The AutoDiffusion gate (tests/test_auto_diffusion.py) over initial
weights: how its test PSNR spreads over seeds, in the JAX package and in the
port, and whether the port trains the JAX package's own initial weights as
the JAX package does.

    python scripts/auto_diffusion_spread.py jax --seeds 42 0 1 2 --inits build/ad_inits.pt
    python scripts/auto_diffusion_spread.py port --device cuda --inits build/ad_inits.pt
    python scripts/auto_diffusion_spread.py port --device cuda --seeds 0 1 2 3 4
    python scripts/auto_diffusion_spread.py port --inits build/ad_inits.pt --only 42 0 \
        --trainer-seeds 42 0 1 2

The gate: ``AutoEncoder(1, 64, 32, 2, capacity=8, down_up_sample=True,
residual="add", time_embed_dim=32, double_encoded_features=True)`` with
``GaussianPrior(loss_coeff=0.1)``, 5 sampler steps, on the seeded synthetic
MNIST32 digits (data seed 42, 3000 train and 500 test images), batch 50, 4
epochs with final-epoch validation, then ``Trainer.test``.

``jax`` needs the JAX package and runs on the CPU in f32. For each seed s it
runs the JAX gate as its test does with ``Trainer(seed=s)``: the initial
weights are ``init_variables(PRNGKey(s) folded with 0, first batch)`` and s
keys the trainer's draws. It prints each run's test PSNR and, with
``--inits``, saves each seed's initial weights in the port's layout
(``jax_variables_to_state_dict``) to that file.

``port`` runs the port's gate on ``--device``, its weights either loaded
from ``--inits`` (each seed the file holds, or those of ``--only``) or drawn
by ``torch.manual_seed(s)`` for each of ``--seeds``, as chip_smoke.py's
phase 28 draws them; once for each of ``--trainer-seeds`` (42, the gate's,
by default), which key the trainer's draws of t and ε in training and
evaluation. It prints each run's test PSNR, and the median of the runs.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

EPOCHS = 4
AE_ARGS = (1, 64, 32, 2)
AE_KW = dict(capacity=8, down_up_sample=True, residual="add", time_embed_dim=32,
             double_encoded_features=True)
DATA = dict(train_batch_size=50, val_batch_size=50, test_batch_size=50, seed=42,
            synthetic_train=3000, synthetic_test=500)


def run_jax(seeds, inits_path):
    import jax
    import jax.numpy as jnp
    import torch

    from ot_vae_tpu.data import MNIST32
    from ot_vae_tpu.metrics import PSNR, MetricCollection
    from ot_vae_tpu.models import AutoDiffusion
    from ot_vae_tpu.networks import AutoEncoder
    from ot_vae_tpu.priors import GaussianPrior
    from ot_vae_tpu.trainer import Trainer
    from ot_vae_tpu_torch.convert import jax_variables_to_state_dict

    jax.config.update("jax_platforms", "cpu")
    inits, psnrs = {}, []
    for s in seeds:
        start = time.perf_counter()
        dm = MNIST32(**DATA)
        model = AutoDiffusion(metrics=MetricCollection({"psnr": PSNR()}),
                              autoencoder=AutoEncoder(*AE_ARGS, **AE_KW),
                              prior=GaussianPrior(loss_coeff=0.1), n_steps=5)
        trainer = Trainer(max_epochs=EPOCHS, seed=s, log_every_n_steps=25,
                          check_val_every_n_epoch=EPOCHS)
        dm.setup()
        first = jax.tree_util.tree_map(jnp.asarray, next(iter(dm.train_batches())))
        # the trainer's own initialisation (Trainer.fit), made here to keep it
        model.variables = model.init_variables(trainer._key(0), first)
        inits[s] = jax_variables_to_state_dict(jax.device_get(model.variables))
        trainer.fit(model, dm)
        psnr = float(trainer.test(model, dm)["test/metrics/psnr"])
        psnrs.append(psnr)
        print(f"jax seed {s}: test PSNR {psnr:.3f} dB ({time.perf_counter() - start:.1f} s)",
              flush=True)
    print(f"jax: test PSNR {[round(p, 3) for p in psnrs]} over seeds {list(seeds)}, "
          f"median {statistics.median(psnrs):.3f} dB", flush=True)
    if inits_path:
        torch.save(inits, inits_path)


def port_model(seed: int, device):
    import torch

    from ot_vae_tpu_torch.metrics import PSNR, MetricCollection
    from ot_vae_tpu_torch.models import AutoDiffusion
    from ot_vae_tpu_torch.networks import AutoEncoder
    from ot_vae_tpu_torch.priors import GaussianPrior

    torch.manual_seed(seed)
    return AutoDiffusion(metrics=MetricCollection({"psnr": PSNR()}),
                         autoencoder=AutoEncoder(*AE_ARGS, **AE_KW),
                         prior=GaussianPrior(loss_coeff=0.1), n_steps=5)


def run_port(device, seeds, inits_path, only=None, trainer_seeds=(42,)):
    import torch

    from ot_vae_tpu_torch.data import MNIST32
    from ot_vae_tpu_torch.trainer import Trainer

    if device == "cuda":
        from ot_vae_tpu_torch.ops import _build
        _build.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    inits = torch.load(inits_path) if inits_path else {s: None for s in seeds}
    if only:
        inits = {s: inits[s] for s in only}
    dm = MNIST32(**DATA)
    dm.setup()
    for ts in trainer_seeds:
        psnrs = []
        for s, state in inits.items():
            start = time.perf_counter()
            model = port_model(s, device)
            if state is not None:
                model.net.load_state_dict(state, strict=True)
            trainer = Trainer(max_epochs=EPOCHS, seed=ts, log_every_n_steps=25,
                              check_val_every_n_epoch=EPOCHS, device=device)
            trainer.fit(model, dm)
            psnr = float(trainer.test(model, dm)["test/metrics/psnr"])
            psnrs.append(psnr)
            what = "JAX-drawn weights of seed" if state is not None else "weights from seed"
            print(f"port on {device}, {what} {s}, trainer seed {ts}: test PSNR {psnr:.3f} dB "
                  f"({time.perf_counter() - start:.1f} s)", flush=True)
        print(f"port on {device}, trainer seed {ts}: test PSNR {[round(p, 3) for p in psnrs]} "
              f"over seeds {list(inits)}, median {statistics.median(psnrs):.3f} dB", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("package", choices=["jax", "port"])
    p.add_argument("--seeds", type=int, nargs="*", default=[42, 0, 1, 2])
    p.add_argument("--inits", default=None, help="initial weights file (port layout)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--only", type=int, nargs="*", help="the seeds of --inits to train")
    p.add_argument("--trainer-seeds", type=int, nargs="+", default=[42])
    a = p.parse_args(argv)
    if a.package == "jax":
        run_jax(a.seeds, a.inits)
    else:
        run_port(a.device, a.seeds, a.inits, a.only, a.trainer_seeds)


if __name__ == "__main__":
    main()
