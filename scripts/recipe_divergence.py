#!/usr/bin/env python3
"""The FFHQ128 and MNIST32 CNN VAE recipes (Adam at 1e-3) from seeded
random weights: does the loss stay finite, in the port and in the JAX
package, and how far does the MNIST32 VAE train?

    python scripts/recipe_divergence.py port [--model ffhq128] [--device cuda] [--batches 4 16 128]
    python scripts/recipe_divergence.py jax [--model ffhq128] [--batch 4] [--steps 10]
    python scripts/recipe_divergence.py fit [--recipes gate config clip] [--seeds 0 1 2 3 4 5]

``--model`` picks the VAE: ``ffhq128`` is configs/vae/ffhq128.yaml at full
width (capacity 64, 128² ↔ 4², head dim 64), ``mnist32`` is
configs/vae/defaults.yaml (capacity 8, 32² ↔ 1², latent 128); both with
GaussianPrior(loss_coeff=0.1). The weights are those ``torch.manual_seed(seed)``
draws, as chip_smoke.py does. FFHQ128 trains on ``batch · steps`` seeded
synthetic images; MNIST32 on the first ``steps`` batches of epoch 0 of the
config's data as chip_smoke.py phase 13 trains on it (6000 seeded synthetic
digits, data and trainer seed 42).

``port`` trains the port alone on ``--device`` at each batch size with the
trainer's own draws of ε and prints the losses per step and the first step
whose loss is not finite. ``jax`` needs the JAX package and runs on the CPU in
f32: the same weights, carried across with ``state_dict_to_jax_variables``,
go through the JAX ``loss_fn`` and optax's Adam, and the port's train step
takes the same batches and the JAX trainer's ε. It prints both losses per
step and each side's largest prior loss.

``fit`` trains the MNIST32 VAE with ``Trainer.fit`` and ``Trainer.test`` on
``--device`` and prints each run's first non-finite step, largest prior loss,
loss and PSNRs, per recipe and seed:

- ``gate``: the JAX package's own end-to-end gate (tests/test_vae_mnist.py):
  batch 50, 3000 synthetic train and 500 test digits, 6 epochs (360 steps),
  a test PSNR floor of 15 dB; seeds 0 and 1;
- ``config``: the config's batch of 250, no clipping, on the default
  synthetic fallback (6000 train, 1000 test digits), ``--epochs`` epochs
  (10 by default: 240 steps, as chip_smoke.py runs it), validating every 10;
- ``clip``: ``config`` with global-norm gradient clipping at 1.0.

The port itself never imports JAX; only the ``jax`` mode of this script does.
"""
from __future__ import annotations

import argparse
import itertools
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

MODELS = {
    "ffhq128": dict(
        encoder=dict(in_features=3, out_features=512, in_resolution=128, out_resolution=4,
                     capacity=64, down_sample=True, residual="add", attn_head_dim=64),
        decoder=dict(in_features=256, out_features=3, in_resolution=4, out_resolution=128,
                     capacity=64, up_sample=True, residual="add", attn_head_dim=64),
        latent=(4, 4, 256)),
    "mnist32": dict(
        encoder=dict(in_features=1, out_features=256, in_resolution=32, out_resolution=1,
                     capacity=8, down_sample=True, residual="add"),
        decoder=dict(in_features=128, out_features=1, in_resolution=1, out_resolution=32,
                     capacity=8, up_sample=True, residual="add"),
        latent=(1, 1, 128)),
}
# data and trainer seed of the MNIST32 runs (chip_smoke.py phase 13)
MNIST32_SEED = 42
LR = 1e-3
LOSSES = ("train/loss/total", "train/loss/recon", "train/loss/prior")


class _Recorder:
    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step):
        self.rows.append((step, dict(metrics)))


def port_model(name: str, seed: int, dtype: torch.dtype = torch.float32, clip=None):
    from ot_vae_tpu_torch.metrics import PSNR, MetricCollection
    from ot_vae_tpu_torch.models import VAE
    from ot_vae_tpu_torch.networks import CNN
    from ot_vae_tpu_torch.priors import GaussianPrior

    spec = MODELS[name]
    torch.manual_seed(seed)
    return VAE(CNN(**spec["encoder"], dtype=dtype), CNN(**spec["decoder"], dtype=dtype),
               GaussianPrior(loss_coeff=0.1), metrics=MetricCollection({"psnr": PSNR()}),
               learning_rate=LR, gradient_clip_val=clip)


def data_seed(name: str, seed: int) -> int:
    return MNIST32_SEED if name == "mnist32" else seed


def datamodule(name: str, batch: int, steps: int, seed: int):
    from ot_vae_tpu_torch.data import FFHQ128, MNIST32

    if name == "ffhq128":
        dm = FFHQ128(root=("/nonexistent/train", "/nonexistent/test"),
                     synthetic_train=batch * steps, synthetic_test=10,
                     train_batch_size=batch, seed=seed)
    else:
        dm = MNIST32(train_batch_size=batch, val_batch_size=batch, test_batch_size=batch,
                     seed=MNIST32_SEED)
    dm.setup()
    return dm


def first_bad(losses):
    return next((i + 1 for i, v in enumerate(losses) if not math.isfinite(v)), None)


def run_port(args):
    from ot_vae_tpu_torch.trainer import Trainer

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[args.dtype]
    if args.dtype == "f32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    for batch in args.batches:
        dm = datamodule(args.model, batch, args.steps, args.seed)
        model = port_model(args.model, args.seed, dtype)
        trainer = Trainer(device=args.device, seed=data_seed(args.model, args.seed))
        trainer.setup_fit(model, dm)
        losses = []
        for i, b in enumerate(itertools.islice(dm.train_batches(0), args.steps)):
            logs, _ = trainer.train_step(model, b, trainer.generator(1, 0, i))
            losses.append(float(logs["train/loss/total"]))
        bad = first_bad(losses)
        print(f"port {args.model} {args.dtype} on {args.device}, batch {batch}, lr {LR:g}: "
              "losses " + " ".join(f"{v:.4g}" for v in losses)
              + ("; all finite" if bad is None else f"; first non-finite at step {bad}"),
              flush=True)
        del model, trainer


def run_jax(args):
    import jax
    import jax.numpy as jnp
    import optax

    from ot_vae_tpu.models import VAE as JaxVAE
    from ot_vae_tpu.networks import CNN as JaxCNN
    from ot_vae_tpu.priors import GaussianPrior as JaxGaussianPrior
    from ot_vae_tpu.trainer.trainer import Trainer as JaxTrainer
    from ot_vae_tpu_torch.convert import state_dict_to_jax_variables
    from ot_vae_tpu_torch.trainer import Trainer

    spec = MODELS[args.model]
    seed = data_seed(args.model, args.seed)
    dm = datamodule(args.model, args.batch, args.steps, args.seed)
    model = port_model(args.model, args.seed)
    variables = state_dict_to_jax_variables(model.net.state_dict())
    jm = JaxVAE(encoder=JaxCNN(**spec["encoder"]), decoder=JaxCNN(**spec["decoder"]),
                prior=JaxGaussianPrior(loss_coeff=0.1), learning_rate=LR)

    def loss(params, mutable, samples, step, key):
        pbatch = {"samples": samples, "target": samples, "kwargs": {}}
        value, (logs, _, mutated) = jm.loss_fn({"params": params, **mutable}, pbatch, step,
                                               {"prior": key, "dropout": key})
        return value, (logs, mutated)

    grad_fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    opt = jm.optimizer()

    @jax.jit
    def adam(grads, opt_state, params):
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    mutable = {"batch_stats": jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])}
    opt_state = opt.init(params)
    trainer = Trainer(device="cpu", seed=seed)
    trainer.setup_fit(model, dm)
    rows = {"jax": [], "port": []}
    for i, (images, labels) in enumerate(itertools.islice(dm.train_batches(0), args.steps)):
        # k_prior of the JAX trainer's step i of epoch 0 (trainer.py:146-151, 180)
        key = jax.random.split(JaxTrainer(seed=seed)._key(1, 0, i), 3)[1]
        (_, (logs, mutated)), grads = grad_fn(params, mutable, jnp.asarray(images), i, key)
        params, opt_state = adam(grads, opt_state, params)
        mutable = {**mutable, **mutated}
        eps = np.array(jax.random.normal(key, (args.batch, *spec["latent"]), jnp.float32))
        plogs, _ = trainer.train_step(model, (images, labels), noise=eps)
        rows["jax"].append([float(logs[k]) for k in LOSSES])
        rows["port"].append([float(plogs[k]) for k in LOSSES])
        print(f"step {i + 1}: (total, recon, prior) jax "
              + " ".join(f"{v:.6g}" for v in rows["jax"][-1]) + ", port "
              + " ".join(f"{v:.6g}" for v in rows["port"][-1]), flush=True)
    for side, values in rows.items():
        bad = first_bad([r[0] for r in values])
        print(f"{side} {args.model} f32 on the CPU, batch {args.batch}, lr {LR:g}: "
              + ("all finite" if bad is None else f"first non-finite at step {bad}")
              + f"; largest prior loss {np.nanmax([r[2] for r in values]):.6g}", flush=True)


def fit(name, dm, epochs, seed, device, clip=None, val_every=1):
    from ot_vae_tpu_torch.trainer import Trainer

    model = port_model("mnist32", seed, clip=clip)
    rec = _Recorder()
    trainer = Trainer(max_epochs=epochs, seed=MNIST32_SEED, logger=rec, log_every_n_steps=1,
                      check_val_every_n_epoch=val_every, device=device)
    start = time.perf_counter()
    trainer.fit(model, dm)
    test = trainer.test(model, dm)
    seconds = time.perf_counter() - start
    val = [round(m["val/metrics/psnr"], 3) for _, m in rec.rows if "val/metrics/psnr" in m]
    losses = np.array([m["train/loss/total"] for _, m in rec.rows if "train/loss/total" in m])
    prior = np.array([m["train/loss/prior"] for _, m in rec.rows if "train/loss/prior" in m])
    bad = first_bad(losses)
    print(f"{name}: batch {dm.train_batch_size}, {len(losses)} steps, seed {seed}: "
          + (f"first non-finite loss at step {bad}; " if bad else "all finite; ")
          + f"largest prior loss {np.nanmax(prior):.4g}; loss (mean of 10) "
          f"{np.mean(losses[:10]):.4g} -> {np.mean(losses[-10:]):.4g}; val PSNR "
          f"{val}; test PSNR {test['test/metrics/psnr']:.3f} dB; {seconds:.1f} s", flush=True)


def run_fit(args):
    from ot_vae_tpu_torch.data import MNIST32

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("recipe_divergence: CUDA is not available", file=sys.stderr)
            return 2
        print(torch.cuda.get_device_name(0), flush=True)
    if "gate" in args.recipes:
        gate = MNIST32(train_batch_size=50, val_batch_size=50, test_batch_size=50,
                       predict_batch_size=50, seed=MNIST32_SEED, synthetic_train=3000,
                       synthetic_test=500)
        for seed in (0, 1):
            fit("gate", gate, 6, seed, args.device)
    config = MNIST32(train_batch_size=250, val_batch_size=250, test_batch_size=250,
                     seed=MNIST32_SEED)
    options = {"config": {}, "clip": {"clip": 1.0}}
    for seed in args.seeds:
        for recipe in (r for r in options if r in args.recipes):
            fit(f"config {recipe}" if recipe != "config" else "config", config, args.epochs,
                seed, args.device, val_every=10, **options[recipe])
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="mode", required=True)
    port = sub.add_parser("port", help="the port alone, at each batch size")
    port.add_argument("--device", default="cuda")
    port.add_argument("--dtype", choices=("bf16", "f32"), default="f32")
    port.add_argument("--batches", type=int, nargs="+", default=[4, 16, 128])
    port.add_argument("--steps", type=int, default=20)
    jx = sub.add_parser("jax", help="the JAX package and the port, on the CPU")
    jx.add_argument("--batch", type=int, default=4)
    jx.add_argument("--steps", type=int, default=10)
    for p in (port, jx):
        p.add_argument("--model", choices=tuple(MODELS), default="ffhq128")
        p.add_argument("--seed", type=int, default=0)
    ft = sub.add_parser("fit", help="MNIST32 fits per recipe and seed")
    ft.add_argument("--device", default="cuda")
    ft.add_argument("--recipes", nargs="+", choices=("gate", "config", "clip"),
                    default=["gate", "config", "clip"])
    ft.add_argument("--seeds", type=int, nargs="+", default=list(range(6)))
    ft.add_argument("--epochs", type=int, default=10)
    args = parser.parse_args(argv)
    return {"port": run_port, "jax": run_jax, "fit": run_fit}[args.mode](args) or 0


if __name__ == "__main__":
    sys.exit(main())
