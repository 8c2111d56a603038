#!/usr/bin/env python3
"""Drive the PyTorch port (ot_vae_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. Phases, each printing one line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles every kernel in ot_vae_tpu_torch/ops/csrc with nvcc;
3. kernel: the packed-attention CUDA kernel against its plain PyTorch version
   at the FFHQ128 model's six attention shapes (B=64), bf16 and f32, and its
   time beside the bound, the plain version and SDPA (a yardstick only);
4. serve: the FFHQ128 CNN VAE at full width, seeded random weights, bf16
   activations with f32 parameters, through InferenceEngine with buckets
   (1, 8, 64); checks shapes, finiteness and the kernel's launch counts, and
   prints img/s per endpoint at bucket 64;
5. whole path: the same weights in f32 on the card against the port on the
   CPU (plain attention), reconstruct of 4 images with the same noise.

Then a JSON line of the kernels and, last, {"ok": true, "device": {...}}.
Any failed check exits non-zero before the last line.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# FFHQ128 (configs/vae/ffhq128.yaml): encoder and decoder attention blocks as
# (name, tokens T, heads H) at head dim 64
ATTN_SHAPES = [("enc2", 256, 4), ("enc3", 64, 8), ("enc4", 16, 8),
               ("dec0", 64, 4), ("dec1", 256, 4), ("dec2", 1024, 2)]
HEAD_DIM = 64
BATCH = 64
# kernel vs plain version, max abs error. f32: the same f32 arithmetic summed
# in another order over up to 1024 keys. bf16: the plain version rounds P to
# bf16 before P·V and both round the output, two bf16 ulps at |out| < 4.
OUT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-5}
LSE_TOL = 1e-4  # f32 in both dtypes, on exactly converted inputs
# whole path, f32 on card and CPU, max abs error over max(1, max|output|):
# about forty conv layers whose sums cuDNN and oneDNN order differently
# (measured 6.1e-6 at an output range of 1.15)
PATH_TOL = 1e-4


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise CheckFailed(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def time_ms(fn, reps: int = 25, flush: torch.Tensor = None) -> float:
    """Median of ``reps`` CUDA-event timings of one call, L2 flushed before
    each call when ``flush`` (a buffer larger than L2) is given."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernel(attention):
    """Kernel against its plain version at the path's shapes; times at the
    T=1024 and T=256 shapes in bf16, the path's dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    scale = 1.0 / math.sqrt(HEAD_DIM)
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for t, h in sorted({(t, h) for _, t, h in ATTN_SHAPES}):
            qkv = torch.randn((BATCH, t, 3 * h * HEAD_DIM), generator=gen,
                              device="cuda").to(dtype)
            out, lse = attention.attention_packed(qkv, h, scale)
            torch.cuda.synchronize()
            ref_out, ref_lse = attention.attention_packed_reference(qkv, h, scale)
            err = (out.float() - ref_out.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            name = str(dtype).replace("torch.", "")
            print(f"kernel check {name} B={BATCH} T={t} H={h} C={HEAD_DIM}: "
                  f"out max_abs_err={err:.3e} (tol {OUT_TOL[dtype]:.1e}) "
                  f"lse max_abs_err={lse_err:.3e} (tol {LSE_TOL:.1e})", flush=True)
            check(math.isfinite(err) and err <= OUT_TOL[dtype],
                  f"attention out {name} T={t} H={h}: {err}")
            check(math.isfinite(lse_err) and lse_err <= LSE_TOL,
                  f"attention lse {name} T={t} H={h}: {lse_err}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    timings = {}
    for t, h in ((1024, 2), (256, 4)):
        dtype = torch.bfloat16
        qkv = torch.randn((BATCH, t, 3 * h * HEAD_DIM), generator=gen,
                          device="cuda").to(dtype)
        q, k, v = qkv.view(BATCH, t, 3, h, HEAD_DIM).permute(2, 0, 3, 1, 4)
        itemsize = qkv.element_size()
        n_bytes = (qkv.numel() + BATCH * t * h * HEAD_DIM) * itemsize + BATCH * t * h * 4
        flops = 4.0 * t * t * HEAD_DIM * BATCH * h
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
        row = {
            "ms": time_ms(lambda: attention.attention_packed(qkv, h, scale), flush=flush),
            "plain_ms": time_ms(lambda: attention.attention_packed_reference(qkv, h, scale),
                                flush=flush),
            "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=scale), flush=flush),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        }
        timings[(t, h)] = row
        print(f"kernel time bf16 B={BATCH} T={t} H={h} C={HEAD_DIM}: "
              f"kernel {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms, "
              f"sdpa {row['library_ms']:.4f} ms; "
              f"{flops / row['ms'] / 1e9:.1f} TFLOP/s", flush=True)
    del flush
    return worst, timings


def ffhq128_vae(dtype, seed: int):
    """The FFHQ128 CNN VAE of configs/vae/ffhq128.yaml, weights from ``seed``."""
    from ot_vae_tpu_torch.data import ffhq128_transforms
    from ot_vae_tpu_torch.models import VAE
    from ot_vae_tpu_torch.networks import CNN
    from ot_vae_tpu_torch.priors import GaussianPrior

    torch.manual_seed(seed)
    model = VAE(
        CNN(3, 512, 128, 4, capacity=64, down_sample=True, residual="add",
            attn_head_dim=64, dtype=dtype),
        CNN(256, 3, 4, 128, capacity=64, up_sample=True, residual="add",
            attn_head_dim=64, dtype=dtype),
        GaussianPrior())
    model.inference_preprocess, model.inference_postprocess = ffhq128_transforms()
    return model


def calibrate_batch_norm(model, seed: int, n: int = 16):
    """Set each batch norm's running statistics to those of its own input on
    one seeded batch, in forward order, as a trained model's are. Random
    weights with unit statistics leave the encoder's log-variance in the
    tens, so σ = exp(log σ²/2) is huge and the reconstruct amplifies f32
    rounding beyond any useful tolerance."""
    from ot_vae_tpu_torch.networks.nets_utils import BatchNorm

    def use_input_statistics(module, args):
        x = args[0].float()
        module.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        module.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    device = model.device
    gen = torch.Generator(device=device).manual_seed(seed)
    images = torch.rand((n, 128, 128, 3), generator=gen, device=device)
    noise = torch.randn((n, *model.latent_size), generator=gen, device=device)
    hooks = [m.register_forward_pre_hook(use_input_statistics)
             for m in model.modules() if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model.net(model.inference_preprocess(images), noise=noise)
    finally:
        for hook in hooks:
            hook.remove()


def phase_serve(attention, seed: int):
    """The slice's main path: the engine's four endpoints at full width."""
    from ot_vae_tpu_torch.serving import InferenceEngine

    model = ffhq128_vae(torch.bfloat16, seed).to("cuda", memory_format=torch.channels_last)
    calibrate_batch_norm(model, seed)
    engine = InferenceEngine(model, batch_sizes=(1, 8, 64))
    rng = np.random.default_rng(seed)
    images = {n: rng.uniform(0, 1, (n, 128, 128, 3)).astype(np.float32)
              for n in (1, 5, 8, 64)}
    expected = {"reconstruct": 6, "encode": 3, "decode": 3, "sample": 3}

    attention.launch_count = 0
    seen = 0

    def request(kind, fn, shape):
        nonlocal seen
        out = fn()
        torch.cuda.synchronize()
        launched = attention.launch_count - seen
        seen = attention.launch_count
        check(out.shape == shape, f"{kind}: shape {out.shape} != {shape}")
        check(bool(np.isfinite(out).all()), f"{kind}: non-finite output")
        check(launched == expected[kind],
              f"{kind}: kernel launched {launched} times, expected {expected[kind]}")
        return out

    for n in (1, 5, 64):
        request("reconstruct", lambda: engine.reconstruct(images[n]), (n, 128, 128, 3))
    z = request("encode", lambda: engine.encode(images[8]), (8, 4, 4, 256))
    request("decode", lambda: engine.decode(z), (8, 128, 128, 3))
    request("sample", lambda: engine.sample(8), (8, 128, 128, 3))
    launches = attention.launch_count
    check(launches == 27, f"main path launched the kernel {launches} times, expected 27")
    print(f"serve FFHQ128 bf16 full width: reconstruct 1/5/64, encode 8, decode 8, "
          f"sample 8 ok; attention kernel launches {launches}", flush=True)

    z64 = engine.encode(images[64])
    calls = {"reconstruct": lambda: engine.reconstruct(images[64]),
             "encode": lambda: engine.encode(images[64]),
             "decode": lambda: engine.decode(z64),
             "sample": lambda: engine.sample(64)}
    rates = {}
    for kind, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        reps = 5
        start = time.perf_counter()
        for _ in range(reps):
            fn()  # returns host numpy: each call ends synchronised
        rates[kind] = 64 * reps / (time.perf_counter() - start)
    print("serve img/s at bucket 64 (bf16): " + ", ".join(
        f"{k} {v:.1f}" for k, v in rates.items()), flush=True)
    return launches, engine


def phase_whole_path(bf16_engine, seed: int):
    """f32 on the card (kernel, TF32 off) against the port on the CPU."""
    from ot_vae_tpu_torch.serving import InferenceEngine

    state = {k: v.cpu() for k, v in bf16_engine.model.state_dict().items()}
    rng = np.random.default_rng(seed + 1)
    images = rng.uniform(0, 1, (4, 128, 128, 3)).astype(np.float32)
    noise = rng.standard_normal((4, 4, 4, 256)).astype(np.float32)
    outs = {}
    for device in ("cuda", "cpu"):
        model = ffhq128_vae(torch.float32, seed)
        model.load_state_dict(state, strict=True)
        outs[device] = InferenceEngine(model, device=device).reconstruct(images, noise=noise)
    ref = outs["cpu"]
    err = float(np.abs(outs["cuda"] - ref).max())
    tol = PATH_TOL * max(1.0, float(np.abs(ref).max()))
    bf16_err = float(np.abs(bf16_engine.reconstruct(images, noise=noise) - ref).max())
    print(f"whole path f32 card vs CPU, reconstruct 4: max_abs_err={err:.3e} "
          f"(tol {tol:.3e}, output range {np.abs(ref).max():.3f}); "
          f"bf16 card vs f32 CPU (not checked): {bf16_err:.3e}", flush=True)
    check(bool(np.isfinite(outs["cuda"]).all()) and err <= tol,
          f"whole path: card vs CPU {err} > {tol}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of weights and inputs")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "ot_vae_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: ot_vae_tpu_torch/ is missing; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from ot_vae_tpu_torch.ops import _build, attention

    smi = nvidia_smi()
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    try:
        start = time.perf_counter()
        built = _build.build_all()
        print(f"build: {time.perf_counter() - start:.1f} s "
              f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or 'cached'})",
              flush=True)
        worst, timings = phase_kernel(attention)
        launches, engine = phase_serve(attention, args.seed)
        phase_whole_path(engine, args.seed)
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    main_shape = timings[(1024, 2)]
    kernels = [{
        "name": "attention_packed_fwd",
        "route": "cuda",
        "source": "ot_vae_tpu_torch/ops/csrc/attention_packed.cu",
        "replaces": "ot_vae_tpu/ops/attention_pallas.py:255",
        "launches": launches,
        "max_abs_err": worst[torch.bfloat16],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
