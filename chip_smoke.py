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
   CPU (plain attention), reconstruct of 4 images with the same noise;
6. backward kernel: the packed-attention backward CUDA kernel against its
   plain PyTorch version at the six attention shapes at the train batch of
   128 and two ragged ones, bf16 and f32; its time beside the bound, the
   plain version and SDPA's backward (a yardstick), and the port's fwd+bwd
   beside SDPA's;
7. train card vs CPU: f32, TF32 off, the same initial weights and ε, batch
   4, two optimizer steps at full width; losses and the first step's
   gradients on the card against the port on the CPU, the gradients held
   against an f64 run of the same step on the CPU;
8. train: Trainer.fit of the FFHQ128 CNN VAE at full width (bf16
   activations, f32 parameters and Adam state, batch 128, lr 1e-4) on the
   seeded synthetic FFHQ128 fallback: 20 steps, one validation with PSNR, a
   checkpoint; checks finite losses, a falling loss and 6 forward and 6
   backward kernel launches per step, and prints steady-state img/s, peak
   memory and the dout copies per step;
9. serve the checkpoint: InferenceEngine(checkpoint_path=...) against the
   in-memory trained model.

Then a JSON line of the kernels and, last, {"ok": true, "device": {...}}.
Any failed check exits non-zero before the last line.
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
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
# kernel vs plain version. f32: max abs error, the same f32 arithmetic summed
# in another order over up to 1024 keys. bf16: max_rel_err (below), the
# plain version rounds P to bf16 before P·V and both round the output
OUT_TOL = 1e-4
LSE_TOL = 1e-4  # f32 in both dtypes, on exactly converted inputs
# whole path, f32 on card and CPU, max abs error over max(1, max|output|):
# about forty conv layers whose sums cuDNN and oneDNN order differently
# (measured 6.1e-6 at an output range of 1.15)
PATH_TOL = 1e-4
TRAIN_BATCH = 128
# ragged backward checks as (T, H, C): odd T, the smallest and largest head dim
RAGGED_SHAPES = [(37, 3, 8), (100, 1, 128)]
# backward kernel vs plain version. f32: max abs error over max(1, max|dqkv|),
# the same f32 products summed in another order over up to 1024 rows
# (measured 1.1e-6 to 3.6e-6 at |dqkv| < 3.6). bf16: max_rel_err (below); both
# round P and dS to bf16 before their products, where another summation
# order can round an entry of P or dS the other way, and both round dqkv
BWD_TOL = 1e-4
# bf16 gate of both kernels: every entry's error over the larger of its own
# size and the RMS of its block (q, k or v columns of dqkv; out), so that each
# shape is held to its own scale. Rounding to bf16 alone moves an entry by
# up to 2^-8 of itself; on an H100 the forward measured 1.08e-2 to 1.49e-2
# and the backward 7.5e-3 to 1.58e-2 over the checked shapes (PERF.md), and
# the limit is about four times the largest
BF16_REL_TOL = 2.0**-4
TRAIN_STEPS = 20
# Adam's learning rate of the gated fit. configs/vae/ffhq128.yaml trains at
# 1e-3; from seeded random weights on the synthetic fallback that recipe
# blows the prior's exp(log σ²) up to inf within 20 steps (PERF.md; see
# scripts/recipe_divergence.py), so the fit that must show a falling loss
# runs at 1e-4
TRAIN_LR = 1e-4
# train card vs CPU, f32 with TF32 off, batch 4, from the same weights and ε:
# - the first loss to 1e-5 relative (one forward in another summation order);
# - the second loss to 1e-2 relative: Adam's first step moves every entry by
#   lr·sign(g), and for the entries whose gradient is rounding noise (biases
#   before a batch norm) card and CPU pick other signs (measured 9.7e-4);
# - the first step's gradients, leaf by leaf, against the same step in f64 on
#   the CPU, to 1e-2 of the leaf's norm on both the card and the CPU. The
#   seeded model's log σ² reaches 10 and exp() amplifies rounding: f32
#   convolutions in cuDNN's or oneDNN's algorithms and sums in other orders
#   moved leaves by up to 2e-3 on an H100 and 4e-4 on its host (PERF.md),
#   where a wrong gradient moves a leaf by O(1). Leaves with no gradient in
#   exact arithmetic (f64 below 1e-9 of the largest) must stay rounding noise,
#   under 1e-5 of the largest, on both.
TRAIN_LOSS_RTOL = (1e-5, 1e-2)
GRAD_RTOL = 1e-2
GRAD_NOISE = 1e-9
GRAD_NOISE_TOL = 1e-5

class CheckFailed(Exception):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise CheckFailed(what)


def max_rel_err(got: torch.Tensor, ref: torch.Tensor, blocks: int) -> float:
    """max |got − ref| / max(|ref|, rms), entry by entry, where rms is that of
    the entry's block: the last dim of ``ref`` split into ``blocks`` equal
    parts (q, k and v of a packed tensor), over all other dims."""
    ref = ref.float()
    parts = ref.view(*ref.shape[:-1], blocks, ref.shape[-1] // blocks)
    dims = tuple(range(parts.dim() - 2)) + (parts.dim() - 1,)
    rms = parts.square().mean(dim=dims, keepdim=True).sqrt()
    err = (got.float().view_as(parts) - parts).abs() / torch.maximum(parts.abs(), rms)
    return err.max().item()


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def time_ms(fn, flush: torch.Tensor = None, reps: int = 25) -> float:
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
            rel = max_rel_err(out, ref_out, 1)
            lse_err = (lse - ref_lse).abs().max().item()
            name = str(dtype).replace("torch.", "")
            gate = (f"max_rel_err={rel:.3e} (tol {BF16_REL_TOL:.1e})"
                    if dtype == torch.bfloat16 else f"(tol {OUT_TOL:.1e})")
            print(f"kernel check {name} B={BATCH} T={t} H={h} C={HEAD_DIM}: "
                  f"out max_abs_err={err:.3e} {gate} "
                  f"lse max_abs_err={lse_err:.3e} (tol {LSE_TOL:.1e})", flush=True)
            ok = rel <= BF16_REL_TOL if dtype == torch.bfloat16 else err <= OUT_TOL
            check(math.isfinite(err) and ok, f"attention out {name} T={t} H={h}: "
                                             f"abs {err}, rel {rel}")
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
    """The FFHQ128 CNN VAE of configs/vae/ffhq128.yaml (prior loss
    coefficient 0.1, PSNR metric, Adam at the model's default 1e-3),
    weights from ``seed``."""
    from ot_vae_tpu_torch.data import ffhq128_transforms
    from ot_vae_tpu_torch.metrics import PSNR, MetricCollection
    from ot_vae_tpu_torch.models import VAE
    from ot_vae_tpu_torch.networks import CNN
    from ot_vae_tpu_torch.priors import GaussianPrior

    torch.manual_seed(seed)
    model = VAE(
        CNN(3, 512, 128, 4, capacity=64, down_sample=True, residual="add",
            attn_head_dim=64, dtype=dtype),
        CNN(256, 3, 4, 128, capacity=64, up_sample=True, residual="add",
            attn_head_dim=64, dtype=dtype),
        GaussianPrior(loss_coeff=0.1), metrics=MetricCollection({"psnr": PSNR()}))
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

    model.eval()
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


def phase_backward(attention):
    """Backward kernel against its plain version at the training path's
    shapes (B=128) and two ragged ones; times at the T=1024 and T=256
    shapes in bf16, the path's dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4321)
    shapes = [(t, h, HEAD_DIM) for t, h in sorted({(t, h) for _, t, h in ATTN_SHAPES})]
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for t, h, c in shapes + RAGGED_SHAPES:
            b, scale = TRAIN_BATCH, 1.0 / math.sqrt(c)
            qkv = torch.randn((b, t, 3 * h * c), generator=gen, device="cuda").to(dtype)
            dout = torch.randn((b, t, h * c), generator=gen, device="cuda").to(dtype)
            out, lse = attention.attention_packed(qkv, h, scale)
            dqkv = attention.attention_packed_backward(qkv, out, lse, dout, h, scale)
            torch.cuda.synchronize()
            ref = attention.attention_packed_backward_reference(qkv, out, lse, dout, h, scale)
            err = (dqkv.float() - ref.float()).abs().max().item()
            rel = max_rel_err(dqkv, ref, 3)
            name = str(dtype).replace("torch.", "")
            if dtype == torch.bfloat16:
                gate, ok = f"max_rel_err={rel:.3e} (tol {BF16_REL_TOL:.1e})", rel <= BF16_REL_TOL
            else:
                tol = BWD_TOL * max(1.0, ref.float().abs().max().item())
                gate, ok = f"(tol {tol:.3e}); max_rel_err={rel:.3e}", err <= tol
            print(f"backward check {name} B={b} T={t} H={h} C={c}: dqkv max_abs_err="
                  f"{err:.3e} {gate}", flush=True)
            check(math.isfinite(err) and ok,
                  f"attention backward {name} T={t} H={h} C={c}: abs {err}, rel {rel}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            del qkv, dout, out, lse, dqkv, ref

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    timings = {}
    for t, h in ((1024, 2), (256, 4)):
        b, c, dtype, scale = TRAIN_BATCH, HEAD_DIM, torch.bfloat16, 1.0 / math.sqrt(HEAD_DIM)
        qkv = torch.randn((b, t, 3 * h * c), generator=gen, device="cuda").to(dtype)
        dout = torch.randn((b, t, h * c), generator=gen, device="cuda").to(dtype)
        out, lse = attention.attention_packed(qkv, h, scale)
        # each input read once (qkv, out, dout, lse), dqkv written once;
        # S, dP, dV, dQ and dK are 2·T²·C FLOP each per (b, h)
        n_bytes = (2 * qkv.numel() + out.numel() + dout.numel()) * qkv.element_size() \
            + lse.numel() * 4
        flops = 10.0 * t * t * c * b * h
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
        # SDPA (a yardstick only) on [B, H, T, C] copies: its backward alone
        # from one retained forward graph, and forward + backward
        q, k, v = (x.contiguous().requires_grad_() for x in
                   qkv.view(b, t, 3, h, c).permute(2, 0, 3, 1, 4))
        dout_bhtc = dout.view(b, t, h, c).transpose(1, 2).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        sdpa_out = sdpa(q, k, v, scale=scale)
        x = qkv.detach().requires_grad_()
        row = {
            "ms": time_ms(lambda: attention.attention_packed_backward(
                qkv, out, lse, dout, h, scale), flush),
            "plain_ms": time_ms(lambda: attention.attention_packed_backward_reference(
                qkv, out, lse, dout, h, scale), flush, reps=10),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                sdpa_out, (q, k, v), dout_bhtc, retain_graph=True), flush),
            "fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
                attention.fused_attention_packed(x, h, scale), x, dout), flush),
            "sdpa_fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
                sdpa(q, k, v, scale=scale), (q, k, v), dout_bhtc), flush),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        }
        timings[(t, h)] = row
        print(f"backward time bf16 B={b} T={t} H={h} C={c}: kernel {row['ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
              f"{row['plain_ms']:.4f} ms, sdpa backward {row['library_ms']:.4f} ms; "
              f"fwd+bwd: port {row['fwd_bwd_ms']:.4f} ms, sdpa "
              f"{row['sdpa_fwd_bwd_ms']:.4f} ms; {flops / row['ms'] / 1e9:.1f} TFLOP/s",
              flush=True)
        del qkv, dout, out, lse, q, k, v, dout_bhtc, sdpa_out, x
    del flush
    return worst, timings


class _Recorder:
    """Logger keeping every logged row."""

    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step):
        self.rows.append((step, dict(metrics)))


def phase_train(attention, seed: int, workdir: Path):
    """The slice's main path: Trainer.fit at full width, batch 128."""
    from ot_vae_tpu_torch.data import FFHQ128
    from ot_vae_tpu_torch.trainer import Callback, ModelCheckpointCallback, Trainer

    class StepProbe(Callback):
        """Synchronises after each step and records the time and the
        kernel counters."""

        def __init__(self):
            self.rows = []

        def _record(self):
            torch.cuda.synchronize()
            self.rows.append((time.perf_counter(), attention.launch_count,
                              attention.backward_launch_count, attention.dout_copies))

        def on_train_epoch_start(self, trainer, model):
            self._record()

        def on_train_batch_end(self, trainer, model, outputs, batch, batch_idx):
            self._record()

    # no images under the work directory: the seeded synthetic FFHQ128
    # fallback, 2560 train images, 285 test images of which 256 (0.9) validate
    data = workdir / "ffhq128"
    dm = FFHQ128(root=(str(data / "train"), str(data / "test")), synthetic_train=2560,
                 synthetic_test=285, train_batch_size=TRAIN_BATCH,
                 val_batch_size=TRAIN_BATCH, seed=seed)
    start = time.perf_counter()
    dm.setup()
    data_s = time.perf_counter() - start
    model = ffhq128_vae(torch.bfloat16, seed)
    model.learning_rate = TRAIN_LR
    probe, logger = StepProbe(), _Recorder()
    ckpt = ModelCheckpointCallback(dirpath=str(workdir / "checkpoints"))
    trainer = Trainer(max_epochs=1, limit_batches=TRAIN_STEPS, log_every_n_steps=1,
                      callbacks=[probe, ckpt], logger=logger, seed=seed)
    torch.cuda.reset_peak_memory_stats()
    attention.launch_count = attention.backward_launch_count = attention.dout_copies = 0
    trainer.fit(model, dm)
    torch.cuda.synchronize()
    launches = {"forward": attention.launch_count, "backward": attention.backward_launch_count}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    losses = [m["train/loss/total"] for _, m in logger.rows if "train/loss/total" in m]
    print("train losses per step (total, recon, prior): " + ", ".join(
        f"({m['train/loss/total']:.4g}, {m['train/loss/recon']:.4g}, "
        f"{m['train/loss/prior']:.4g})" for _, m in logger.rows if "train/loss/total" in m),
        flush=True)
    psnr = trainer.logged_metrics.get("val/metrics/psnr", float("nan"))
    check(len(losses) == TRAIN_STEPS, f"train: {len(losses)} losses logged")
    check(all(math.isfinite(v) for v in losses), f"train: non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall ({losses[0]} -> {losses[-1]})")
    check(math.isfinite(psnr), f"train: validation PSNR {psnr}")
    steps = [(b[1] - a[1], b[2] - a[2], b[3] - a[3])
             for a, b in zip(probe.rows[:-1], probe.rows[1:])]
    check(len(steps) == TRAIN_STEPS, f"train: {len(steps)} steps probed")
    bad = [i for i, (f, b, _) in enumerate(steps) if (f, b) != (6, 6)]
    check(not bad, f"train: steps {bad} launched (forward, backward) "
                   f"{[steps[i][:2] for i in bad]}, expected (6, 6)")
    val_batches = min(TRAIN_STEPS, dm.steps_per_epoch("val"))
    check(launches == {"forward": 6 * (TRAIN_STEPS + val_batches),
                       "backward": 6 * TRAIN_STEPS},
          f"train: kernel launches {launches}")
    check(ckpt.best_path is not None, "train: no checkpoint saved")
    times = [r[0] for r in probe.rows]
    steady = 3  # steps 4..20: from the end of step 3 to the end of step 20
    img_s = (TRAIN_STEPS - steady) * TRAIN_BATCH / (times[-1] - times[steady])
    copies = sum(s[2] for s in steps) / TRAIN_STEPS
    print(f"train FFHQ128 bf16 full width, batch {TRAIN_BATCH}, lr {TRAIN_LR:g}: "
          f"{TRAIN_STEPS} steps, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, val PSNR {psnr:.3f} dB; "
          f"kernel launches per step 6 forward + 6 backward (run: {launches}); "
          f"steady train img/s (steps 4-{TRAIN_STEPS}, synchronised) {img_s:.1f}; "
          f"peak memory {peak_gib:.2f} GiB; dout copies per step {copies:.1f}; "
          f"synthetic data {data_s:.1f} s", flush=True)
    return model, ckpt.best_path, launches


def phase_serve_checkpoint(model, path: str, seed: int):
    """The checkpoint served by a fresh engine against the trained model."""
    from ot_vae_tpu_torch.serving import InferenceEngine

    served = InferenceEngine(ffhq128_vae(torch.bfloat16, seed + 1), checkpoint_path=path)
    trained = InferenceEngine(model)
    check(served.model.inference_preprocess == trained.model.inference_preprocess
          and served.model.inference_postprocess == trained.model.inference_postprocess,
          "checkpoint: inference transforms differ")
    rng = np.random.default_rng(seed + 2)
    images = rng.uniform(0, 1, (8, 128, 128, 3)).astype(np.float32)
    noise = rng.standard_normal((8, 4, 4, 256)).astype(np.float32)
    got = served.reconstruct(images, noise=noise)
    want = trained.reconstruct(images, noise=noise)
    err = float(np.abs(got - want).max())
    # the same weights, kernels and shapes: cuDNN may still pick another
    # algorithm for another engine's tensors, so allow 1e-3 of the range
    tol = 1e-3 * max(1.0, float(np.abs(want).max()))
    print(f"serve checkpoint: reconstruct 8 from {Path(path).name} vs the trained "
          f"model: max_abs_err={err:.3e} (tol {tol:.3e})", flush=True)
    check(got.shape == (8, 128, 128, 3) and bool(np.isfinite(got).all()) and err <= tol,
          f"checkpoint: served vs trained {err} > {tol}")


def phase_train_card_vs_cpu(seed: int):
    """Two train steps at full width, batch 4, from the same weights and ε:
    f32 on the card, f32 and f64 on the CPU."""
    from ot_vae_tpu_torch.data import ArrayDataset, BaseDatamodule
    from ot_vae_tpu_torch.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = ffhq128_vae(torch.float32, seed + 3).state_dict()
    rng = np.random.default_rng(seed + 4)
    images = [rng.uniform(0, 1, (4, 128, 128, 3)).astype(np.float32) for _ in range(2)]
    noise = [rng.standard_normal((4, 4, 4, 256)).astype(np.float32) for _ in range(2)]
    labels = np.zeros(4, np.int32)
    runs = {}
    for name, device, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                                ("cpu64", "cpu", torch.float64)):
        model = ffhq128_vae(dtype, seed + 3)
        model.load_state_dict(state, strict=True)
        model.to(dtype)
        trainer = Trainer(device=device, seed=seed)
        trainer.setup_fit(model, BaseDatamodule(train_dataset=ArrayDataset(images[0], labels)))
        losses, grads = [], None
        for x, eps in zip(images, noise):
            logs, _ = trainer.train_step(model, (x, labels), noise=eps)
            losses.append(float(logs["train/loss/total"]))
            if grads is None:
                grads = {k: p.grad.detach().double().cpu()
                         for k, p in model.net.named_parameters()}
        runs[name] = (losses, grads)
    (card_l, card_g), (cpu_l, cpu_g), (_, exact) = runs["card"], runs["cpu"], runs["cpu64"]
    loss_err = [abs(a - b) / max(1.0, abs(b)) for a, b in zip(card_l, cpu_l)]
    scale = max(g.abs().max().item() for g in exact.values())
    worst = {"card": (0.0, ""), "cpu": (0.0, "")}
    n_noise, card_cpu = 0, 0.0
    for name, g in exact.items():
        noise = g.abs().max().item() <= GRAD_NOISE * scale
        n_noise += noise
        if not noise:
            card_cpu = max(card_cpu, (card_g[name] - cpu_g[name]).norm().item() / g.norm().item())
        for side, grads in (("card", card_g), ("cpu", cpu_g)):
            if noise:
                ratio = grads[name].abs().max().item() / (GRAD_NOISE_TOL * scale)
            else:
                ratio = (grads[name] - g).norm().item() / (GRAD_RTOL * g.norm().item())
            worst[side] = max(worst[side], (ratio, name))
    print(f"train card vs CPU f32, batch 4, 2 steps: losses card {card_l} cpu {cpu_l} "
          f"(rel err {loss_err[0]:.3e}, {loss_err[1]:.3e}; tol {TRAIN_LOSS_RTOL[0]:.0e}, "
          f"{TRAIN_LOSS_RTOL[1]:.0e}); first step gradients vs f64 (tol {GRAD_RTOL:.0e} of "
          f"a leaf's norm): card worst {worst['card'][0] * GRAD_RTOL:.3e} at "
          f"{worst['card'][1]}, CPU worst {worst['cpu'][0] * GRAD_RTOL:.3e} at "
          f"{worst['cpu'][1]}; card vs CPU up to {card_cpu:.3e}; {n_noise} leaves with "
          f"no gradient in exact arithmetic", flush=True)
    check(all(math.isfinite(v) for v in card_l)
          and all(e <= t for e, t in zip(loss_err, TRAIN_LOSS_RTOL)),
          f"train card vs CPU: losses {card_l} vs {cpu_l}")
    for side, (ratio, name) in worst.items():
        check(ratio <= 1.0, f"train {side} vs f64: gradient {name} off by {ratio:.3f}x tol")


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
        del engine
        bwd_worst, bwd_timings = phase_backward(attention)
        phase_train_card_vs_cpu(args.seed)
        workdir = ROOT / "build" / "chip_smoke"
        shutil.rmtree(workdir, ignore_errors=True)
        model, checkpoint, train_launches = phase_train(attention, args.seed, workdir)
        phase_serve_checkpoint(model, checkpoint, args.seed)
        shutil.rmtree(workdir, ignore_errors=True)
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    main_shape, bwd_shape = timings[(1024, 2)], bwd_timings[(1024, 2)]
    kernels = [{
        "name": "attention_packed_fwd",
        "route": "cuda",
        "source": "ot_vae_tpu_torch/ops/csrc/attention_packed.cu",
        "replaces": "ot_vae_tpu/ops/attention_pallas.py:255",
        "launches": launches + train_launches["forward"],
        "launches_by_path": {"serve": launches, "train": train_launches["forward"]},
        "max_abs_err": worst[torch.bfloat16],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
    }, {
        "name": "attention_packed_bwd",
        "route": "cuda",
        "source": "ot_vae_tpu_torch/ops/csrc/attention_packed_bwd.cu",
        "replaces": "ot_vae_tpu/ops/attention_pallas.py:279",
        "launches": train_launches["backward"],
        "launches_by_path": {"serve": 0, "train": train_launches["backward"]},
        "max_abs_err": bwd_worst[torch.bfloat16],
        "ms": bwd_shape["ms"],
        "plain_ms": bwd_shape["plain_ms"],
        "bound_ms": bwd_shape["bound_ms"],
        "bound_by": bwd_shape["bound_by"],
        "library_ms": bwd_shape["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
