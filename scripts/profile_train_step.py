#!/usr/bin/env python3
"""Where a train step's device time goes: the FFHQ128 CNN VAE (unfused, or
with its attention blocks fused) or the FFHQ128 ViT VAE at full width.

    python scripts/profile_train_step.py [--seed 0] [--model cnn|cnn_fused|vit]

Builds the model as chip_smoke.py does (bf16 activations, f32 parameters and
Adam state, seeded random weights; the CNN at batch 128 and lr 1e-4, with
``cnn_fused`` through the fused attention block, rows 5 and 6; the ViT of
configs/vae/vit_ffhq128.yaml at batch 32 and lr 1e-3), takes three warm-up
steps on the seeded synthetic FFHQ128 fallback, times five train steps, then
traces five more with ``torch.profiler`` on the card. Prints the wall time of
a step with and without the profiler (host clock, synchronised), the device
time of its kernels by category and the busiest kernels, and last a JSON line
of the same numbers. The idle share is the part of the wall time in which no
kernel ran (kernels of one stream do not overlap); user annotations such as
``Optimizer.step``, which the trace mirrors onto the device, are not kernels.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# first match wins, on the lower-cased kernel name
CATEGORIES = [
    ("attention (port kernels)", ("attention_", "attn_from_lse")),
    ("fused-block projections (port kernels)", ("block_gemm::",)),
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "fprop", "dgrad", "wgrad", "winograd")),
    ("matmul", ("gemm", "cutlass", "cublas", "nvjet")),
    ("optimizer", ("adam", "multi_tensor", "foreach")),
    ("reduction", ("reduce",)),
    ("copy / fill", ("copy", "memcpy", "memset", "fill", "cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]


def category(name: str) -> str:
    low = name.lower()
    for label, keys in CATEGORIES:
        if any(k in low for k in keys):
            return label
    return "other"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of weights and data")
    parser.add_argument("--model", choices=("cnn", "cnn_fused", "vit"), default="cnn",
                        help="the FFHQ128 CNN VAE, the same with its attention blocks "
                             "fused, or the FFHQ128 ViT VAE")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train_step: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from ot_vae_tpu_torch.data import FFHQ128
    from ot_vae_tpu_torch.ops import _build
    from ot_vae_tpu_torch.trainer import Trainer

    _build.build_all()
    if args.model in ("cnn", "cnn_fused"):
        fused = args.model == "cnn_fused"
        build, batch_size, lr = (lambda dtype, seed: chip_smoke.ffhq128_vae(dtype, seed, fused),
                                 chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_LR)
    else:
        build, batch_size, lr = (lambda dtype, seed: chip_smoke.ffhq_vit_vae(seed, dtype),
                                 chip_smoke.VIT_TRAIN_BATCH, chip_smoke.VIT_TRAIN_LR)
    warmup, steps = 3, 5
    dm = FFHQ128(root=("/nonexistent/train", "/nonexistent/test"),
                 synthetic_train=batch_size * (warmup + 2 * steps), synthetic_test=10,
                 train_batch_size=batch_size, seed=args.seed)
    dm.setup()
    model = build(torch.bfloat16, args.seed)
    model.learning_rate = lr
    trainer = Trainer(seed=args.seed)
    trainer.setup_fit(model, dm)
    batches = list(dm.train_batches(0))

    def run(first: int, count: int) -> float:
        """Mean wall ms of train steps first..first+count, synchronised."""
        torch.cuda.synchronize()
        start = time.perf_counter()
        for i in range(first, first + count):
            prior_rng, dropout_rng, preprocess_rng = trainer.step_generators(0, i)
            trainer.train_step(model, batches[i], prior_rng, dropout_rng=dropout_rng,
                               preprocess_rng=preprocess_rng)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3 / count

    run(0, warmup)
    plain_ms = run(warmup, steps)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        wall_ms = run(warmup + steps, steps)

    per_kernel = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        per_kernel[evt.key][0] += us / 1e3 / steps
        per_kernel[evt.key][1] += evt.count / steps
    device_ms = sum(ms for ms, _ in per_kernel.values())
    by_cat = defaultdict(float)
    for name, (ms, _) in per_kernel.items():
        by_cat[category(name)] += ms
    print(f"{args.model} train step, batch {batch_size}, bf16: wall {plain_ms:.3f} ms "
          f"({batch_size / plain_ms * 1e3:.1f} img/s), {wall_ms:.3f} ms with the profiler on; "
          f"kernels {device_ms:.3f} ms, idle {max(0.0, 1 - device_ms / plain_ms):.3f} of the "
          f"wall ({max(0.0, 1 - device_ms / wall_ms):.3f} traced)", flush=True)
    if device_ms == 0.0:
        print("profile_train_step: the trace holds no device time", file=sys.stderr)
        return 1
    for label, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {label}: {ms:.3f} ms per step ({ms / device_ms:.3f} of kernel time)")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:20]
    print("busiest kernels, ms per step (launches per step):")
    for name, (ms, n) in top:
        print(f"  {ms:9.3f} ({n:5.1f})  [{category(name)}] {name[:140]}")
    print(json.dumps({
        "model": args.model, "batch": batch_size, "wall_ms": plain_ms, "traced_wall_ms": wall_ms,
        "device_ms": device_ms,
        "categories_ms": dict(by_cat),
        "top": [{"name": name[:200], "ms": ms, "launches": n} for name, (ms, n) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
