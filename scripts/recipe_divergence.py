#!/usr/bin/env python3
"""The FFHQ128 recipe (Adam at 1e-3) from seeded random weights: does the
loss stay finite, in the port and in the JAX package?

    python scripts/recipe_divergence.py port [--device cuda] [--batches 4 16 128]
    python scripts/recipe_divergence.py jax [--batch 4] [--steps 10]

Both modes build the full-width FFHQ128 CNN VAE of configs/vae/ffhq128.yaml
(capacity 64, 128² ↔ 4², head dim 64, GaussianPrior(loss_coeff=0.1)) with the
weights that ``torch.manual_seed(seed)`` draws, as chip_smoke.py does, and
train on the seeded synthetic FFHQ128 fallback, ``batch · steps`` images.

``port`` trains the port alone on ``--device`` at each batch size with the
trainer's own draws of ε and prints the losses per step and the first step
whose loss is not finite. ``jax`` needs the JAX package and runs on the CPU in
f32: the same weights, carried across with ``state_dict_to_jax_variables``,
go through the JAX ``loss_fn`` and optax's Adam, and the port's train step
takes the same batches and the JAX trainer's ε. It prints both losses per
step. The port itself never imports JAX; only the ``jax`` mode of this script
does.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ENCODER = dict(in_features=3, out_features=512, in_resolution=128, out_resolution=4,
               capacity=64, down_sample=True, residual="add", attn_head_dim=64)
DECODER = dict(in_features=256, out_features=3, in_resolution=4, out_resolution=128,
               capacity=64, up_sample=True, residual="add", attn_head_dim=64)
LATENT = (4, 4, 256)
LR = 1e-3
LOSSES = ("train/loss/total", "train/loss/recon", "train/loss/prior")


def port_model(seed: int, dtype: torch.dtype):
    from ot_vae_tpu_torch.models import VAE
    from ot_vae_tpu_torch.networks import CNN
    from ot_vae_tpu_torch.priors import GaussianPrior

    torch.manual_seed(seed)
    return VAE(CNN(**ENCODER, dtype=dtype), CNN(**DECODER, dtype=dtype),
               GaussianPrior(loss_coeff=0.1), learning_rate=LR)


def datamodule(batch: int, steps: int, seed: int):
    from ot_vae_tpu_torch.data import FFHQ128

    dm = FFHQ128(root=("/nonexistent/train", "/nonexistent/test"),
                 synthetic_train=batch * steps, synthetic_test=10,
                 train_batch_size=batch, seed=seed)
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
        dm = datamodule(batch, args.steps, args.seed)
        model = port_model(args.seed, dtype)
        trainer = Trainer(device=args.device, seed=args.seed)
        trainer.setup_fit(model, dm)
        losses = []
        for i, b in enumerate(dm.train_batches(0)):
            logs, _ = trainer.train_step(model, b, trainer.generator(1, 0, i))
            losses.append(float(logs["train/loss/total"]))
        bad = first_bad(losses)
        print(f"port {args.dtype} on {args.device}, batch {batch}, lr {LR:g}: losses "
              + " ".join(f"{v:.4g}" for v in losses)
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

    dm = datamodule(args.batch, args.steps, args.seed)
    model = port_model(args.seed, torch.float32)
    variables = state_dict_to_jax_variables(model.net.state_dict())
    jm = JaxVAE(encoder=JaxCNN(**ENCODER), decoder=JaxCNN(**DECODER),
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
    trainer = Trainer(device="cpu", seed=args.seed)
    trainer.setup_fit(model, dm)
    rows = {"jax": [], "port": []}
    for i, (images, labels) in enumerate(dm.train_batches(0)):
        # k_prior of the JAX trainer's step i of epoch 0 (trainer.py:146-151, 180)
        key = jax.random.split(JaxTrainer(seed=args.seed)._key(1, 0, i), 3)[1]
        (_, (logs, mutated)), grads = grad_fn(params, mutable, jnp.asarray(images), i, key)
        params, opt_state = adam(grads, opt_state, params)
        mutable = {**mutable, **mutated}
        eps = np.array(jax.random.normal(key, (args.batch, *LATENT), jnp.float32))
        plogs, _ = trainer.train_step(model, (images, labels), noise=eps)
        rows["jax"].append([float(logs[k]) for k in LOSSES])
        rows["port"].append([float(plogs[k]) for k in LOSSES])
        print(f"step {i + 1}: (total, recon, prior) jax "
              + " ".join(f"{v:.6g}" for v in rows["jax"][-1]) + ", port "
              + " ".join(f"{v:.6g}" for v in rows["port"][-1]), flush=True)
    for side, values in rows.items():
        bad = first_bad([r[0] for r in values])
        print(f"{side} f32 on the CPU, batch {args.batch}, lr {LR:g}: "
              + ("all finite" if bad is None else f"first non-finite at step {bad}"),
              flush=True)


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
        p.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    (run_port if args.mode == "port" else run_jax)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
