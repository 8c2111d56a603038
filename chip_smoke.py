#!/usr/bin/env python3
"""Drive the PyTorch port (ot_vae_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. Phases, each printing one line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles every kernel in ot_vae_tpu_torch/ops/csrc with nvcc;
3. kernel: the packed-attention CUDA kernel (row 1) against its plain
   PyTorch version at the FFHQ128 model's six attention shapes (B=64), bf16
   and f32, and in bf16 also where the tensor-core kernel's 64-row tiles,
   padded head dims and 16-byte copies can break (T = 1000 and 65 at C = 64,
   C = 16, 48 and 128, C = 13 with H = 3); its times at T=1024, H=2 and
   T=256, H=4 beside the bound (and their share of it), the plain version
   and SDPA (a yardstick only, and the factor against it);
4. serve: the FFHQ128 CNN VAE at full width, seeded random weights, bf16
   activations with f32 parameters, through InferenceEngine with buckets
   (1, 8, 64); checks shapes, finiteness and the kernel's launch counts, and
   prints img/s per endpoint at bucket 64;
5. whole path: the same weights in f32 on the card against the port on the
   CPU (plain attention), reconstruct of 4 images with the same noise;
6. backward kernel: the packed-attention backward CUDA kernel (row 2)
   against its plain PyTorch version at the six attention shapes at the
   train batch of 128 and two ragged ones, bf16 and f32, and in bf16 at
   phase 3's tile and alignment shapes; every bf16 check runs twice on the
   same inputs and must repeat bit for bit; its times beside the bound (and
   their share of it), the plain version and SDPA's backward (a yardstick,
   and the factor against it), and the port's fwd+bwd beside SDPA's;
7. train card vs CPU: f32, TF32 off, the same initial weights and ε, batch
   4, two optimizer steps at full width; losses and the first step's
   gradients on the card against the port on the CPU, the gradients held
   against an f64 run of the same step on the CPU;
8. train: Trainer.fit of the FFHQ128 CNN VAE at full width (bf16
   activations, f32 parameters and Adam state, batch 128, lr 1e-4) on the
   seeded synthetic FFHQ128 fallback: 20 steps, one validation with PSNR, a
   checkpoint; checks finite losses, a falling loss and 6 forward and 6
   backward kernel launches per step (6 forward per validation batch, whose
   eval step draws its latents from the same encoder pass), and prints
   steady-state img/s, peak memory and the dout copies per step;
9. serve the checkpoint: InferenceEngine(checkpoint_path=...) against the
   in-memory trained model;
10. small head dims: both attention kernels against their plain versions at
   every (T, H, C) of the MNIST32 models' attention blocks (C from 1 to 16,
   T from 256 down to 1), bf16 and f32;
11. Sinkhorn kernel: against its plain version at the latent-transport
   path's reg, max_iter and threshold (1e-5, 1000, 1e-6) on costs built from
   seeded codebooks as DiscreteTransport.compute builds them (one 256 x 256
   instance, 64 x 256 x 256, a ragged 3 x 37 x 200, one 1024 x 1024, and
   2 x 5 x 300, fewer rows than the kernel's cluster has CTAs): the same
   iteration counts, each instance's total cost, the entries at the path's
   256 x 256, marginals as close to a and b as the plain version's; each
   shape's launch plan (cluster size, rows resident and streamed a CTA);
   then a well-conditioned batch whose instances stop at different
   iterations, entry by entry and count by count; its times at 1 x 256 x
   256, 64 x 256 x 256 and 1 x 1024 x 1024 beside the bound and the plain
   version (where that takes under 3 s);
12. MNIST32 latent transport, the JAX gate whole
   (tests/test_latent_transport.py): the AutoEncoder at full width with its
   three LatentTransports on the seeded synthetic MNIST32 fallback, a
   Gaussian operator over the whole latent (D = 1024), a GMM of 10
   diagonal components over each pixel's channels and a 256-atom codebook
   over each channel's map (codebook-to-codebook Sinkhorn), each logging a
   collage of 4 samples; five runs, the weights from five consecutive
   seeds, of Trainer.fit for 4 epochs (one Sinkhorn launch per validation,
   the GMM's coupling being the plain Sinkhorn) and Trainer.test with the
   model's and the restored PSNR (the median over the runs of the
   Gaussian's and the GMM's above the gate's 14 dB), every collage's shape;
   then, on the first run's model, save_state/load_state bit for bit for
   all three, InferenceEngine.restore through the Gaussian and the discrete
   operator against the test-time encode -> transport -> decode path, and
   the fitted discrete plan against the plain version's on its codebooks
   (total cost, the test latents transported and restored through each);
13. MNIST32 VAE (configs/vae/defaults.yaml, capacity 8, latent 1 x 1 x 128)
   trains 240 steps at batch 250, gradients clipped at a global norm of 1.0,
   and Trainer.test reports its PSNR;
14. BTHD and BHTC kernels: the BTHD attention forward kernel (row 7) against
   its plain version at the two ViTs' four attention shapes (B=64), a cross
   shape (Tq != Tk), a ragged T with an odd head dim, causal, with a seeded
   post-softmax multiplier and both, bf16 and f32; in bf16 also where the
   tensor-core kernel's 64-row tiles and padded head dims can break (T =
   1000 and 65 at d = 128, d = 16, 48, 80, 112 and 13, causal with the
   multiplier at T = 1024); the BHTC kernel (row 3, the same source) at the
   self-attention shapes in [B, H, T, d]; the times of both at the FFHQ128
   ViT's two shapes beside the bound (and their share of it), the plain
   version and SDPA (a yardstick only, and the factor against it); then the
   fused_attention entry, the only way to row 3 (no model path reaches it),
   driven at the ViTs' shapes;
15. serve the conditional CIFAR10 ViT VAE (configs/vae/vit.yaml, full
   width, seeded random weights, f32) through InferenceEngine with labels
   from the seeded CIFAR10 fallback at buckets (1, 8, 64): shapes,
   finiteness, 3 BTHD launches per encode, decode and sample and 6 per
   reconstruct, a padded request's rows against the same rows in a full
   bucket, and img/s per endpoint at bucket 64;
16. serve the FFHQ128 ViT VAE (configs/vae/vit_ffhq128.yaml, full width and
   depth, bf16 activations, f32 parameters) at bucket 64 on the seeded
   FFHQ128 fallback: 8/8/16/8 BTHD launches per encode, decode,
   reconstruct and sample, and img/s per endpoint;
17. whole ViT path, f32 on the card against the port on the CPU: both ViT
   VAEs reconstruct a few images with the same ε and labels; then the
   FFHQ128 ViT as served, bf16 on the card against bf16 on the CPU;
18. BTHD and BHTC backward kernels: rows 8 and 4 (one source) against their
   plain versions at the two ViTs' four train shapes (the CIFAR10 ViT's with
   a seeded multiplier), a cross shape, a ragged T with an odd head dim,
   causal, and causal with the multiplier at d = 96 and 128, bf16 and f32,
   and in bf16 at phase 14's tile and padding shapes; every bf16 check runs
   twice on the same inputs and must repeat bit for bit; their times at the
   FFHQ128 ViT's train shapes (B=32) beside the bound (and their share of
   it), the plain version, SDPA's backward (a yardstick only, and the
   factor against it), and the port's forward + backward beside SDPA's;
   then the fused_attention entry's backward, the only way to row 4, at the
   ViTs' shapes;
19. ViT train card vs CPU: f32, TF32 off, batch 4, two optimizer steps of
   the conditional CIFAR10 ViT VAE (full width, dropout 0.1) and of the
   FFHQ128 ViT VAE (full width, depth 2), from the same weights, images,
   labels, ε, dropout masks (drawn on the CPU and handed to the card) and
   flips; losses and the first step's gradients against the CPU and an f64
   run, as phase 7;
20. Trainer.fit of the conditional CIFAR10 ViT VAE at configs/vae/vit.yaml's
   recipe (batch 50, dropout 0.1, flips, lr 1e-3) for one epoch of 12000
   seeded synthetic images (240 steps), one validation with PSNR and a
   checkpoint: finite, falling losses; per step exactly 6 row-7 and 6 row-8
   launches, all 12 with the multiplier; 6 row-7 launches per validation
   batch; then the checkpoint served with labels through
   InferenceEngine(checkpoint_path=...) against the in-memory model;
21. Trainer.fit of the FFHQ128 ViT VAE (bf16 activations, f32 parameters,
   batch 32, lr 1e-3) for 20 steps on the seeded FFHQ128 fallback and one
   validation: finite, falling losses, 16 row-7 and 16 row-8 launches per
   step; prints steady img/s, peak memory and the dout copies per step;
22. fused attention block kernels: rows 5 and 6 against their plain
   versions at the FFHQ128 model's six blocks (forward at B=64, backward at
   the train batch of 128), the MNIST32 attention shapes, a ragged shape
   with C, H·ch and C_out all different and one head of 128 dims, bf16 and
   f32, and in bf16 the tensor-core kernels' tile and alignment edges
   (BLOCK_TILE_SHAPES); row 6 twice on the same inputs, bit for bit; their
   times in bf16 at the decoder's 32² and the encoder's 16² block beside
   the bound (and its share), the plain versions and two yardsticks (the
   port's unfused block, and matmul + SDPA + matmul);
23. serve the FFHQ128 CNN VAE with fused_block=True (bf16, buckets 1, 8,
   64): 6 row-5 launches per reconstruct, 3 per encode, decode and sample,
   no launch of any other kernel; img/s per endpoint at bucket 64 beside
   phase 4's;
24. the fused model in f32: served fused and unfused on the card and fused
   on the CPU, within PATH_TOL of each other; then its first two train
   steps card vs CPU vs f64, as phase 7;
25. Trainer.fit of the fused FFHQ128 CNN VAE as phase 8 (20 steps, batch
   128, lr 1e-4, one validation): finite, falling losses, exactly 6 row-5
   and 6 row-6 launches per step and none of any other kernel; steady img/s,
   peak memory and dout copies beside phase 8's;
26. the OT core on the card at the MNIST32 gate's shapes: GaussianTransport
   (D = 1024, 900 seeded samples a side, under eigh and polar) and a
   diagonal GMMTransport (10 components, D = 64) fitted in f32 with TF32
   allowed, T, the W2 cost and a transported batch against the same port
   code in f64 on the CPU; the Newton-Schulz roots of the fitted covariance
   likewise; every Gaussian result with TF32 allowed equal bit for bit to
   the one with it forbidden; the times of compute and transport;
27. the conditional CIFAR10 ViT gate (tests/test_conditional_vit_vae.py):
   the full-width model of configs/vae/vit.yaml trains 8 epochs of 2500
   seeded synthetic images at batch 50 with the blur curriculum
   (ProgressiveTransform) and a Gaussian LatentTransport whose target
   streams from training (EMA 0.995); test and transported PSNR above the
   gate's 14.5 dB, exactly 6 row-7 and 6 row-8 launches per step (12 with
   the multiplier) and the validations', collages' and test's launches;
28. the AutoDiffusion gate (tests/test_auto_diffusion.py): the time-
   conditioned AutoEncoder (capacity 8, latent 2 x 2 x 64, time embedding
   32) with a Gaussian prior trains 4 epochs of 3000 seeded synthetic MNIST32
   digits at batch 50 (validation in the last), five runs from the JAX
   gate's own initial weights (those the JAX package's Trainer(seed=42)
   draws, reproduced by jax_init) under five trainer seeds; the median
   test PSNR above the gate's 15 dB, t drawn per test image from the eval
   step's generator; on the median run's model the diffusion sampler (5
   steps) with both algorithms finite at 8 x 32 x 32 x
   1, return_steps giving 5 images, InferenceEngine.sample equal to the
   model's sampler; exactly 8 row-1 and 8 row-2 launches a step, 8 row-1 per
   validation and test batch, 40 per standard and 60 per improved sampler
   call, and none of rows 7 and 8; the samplers' times for 8 images;
29. the DAD gate (tests/test_dad.py): configs/dad/defaults.yaml's model
   with dropout 0.1 trains 8 epochs of 2500 seeded synthetic 28² digits at
   batch 50; test PSNR above the gate's 13 dB; 4 samples through
   model.sample, finite; the KV-cached sampler equal to the unrolled oracle
   for one generator; InferenceEngine.sample equal to the model's sampler;
   exactly 6 row-7 and 6 row-8 launches a step, all 12 with the multiplier
   and 4 causal, 4 row-7 per validation and test batch, 4 (2 causal) per
   cached sample, none from its single-token steps, and 32 (30 causal) per
   oracle sample; both samplers' times for 8 images;
30. both models' first two train steps at batch 4, f32 on the card (TF32
   off) against the CPU and an f64 run, from the same weights, images, t,
   ε, Gumbel noise, sampled indices and dropout masks, as phases 7 and 19.

Phases 14 and 18 also check rows 7 and 8 at the DAD's attention shape (B =
50, T = 16, H = 4, d = 16: plain, causal, causal with the multiplier).

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
# bf16 rows 1 and 2 run on the tensor cores in 64-row tiles with head dims
# padded to a multiple of 16, copied by cp.async when C is a multiple of 8
# and by masked scalar loads otherwise; these (B, T, H, C) (bf16 only: f32
# keeps the CUDA-core kernels) cross those edges: T = 1000 and 65 at the
# path's C = 64 (ragged across 64-row tiles, 65 one row past a tile),
# C = 16, 48 and 128 (padded to no width), and C = 13 with H = 3, where
# H·C = 39 starts the k and v column blocks off 16 bytes (scalar copies;
# T = 130 two rows past two tiles)
PACKED_TILE_SHAPES = [(8, 1000, 2, 64), (16, 65, 2, 64), (16, 100, 2, 16), (16, 100, 2, 48),
                      (8, 100, 1, 128), (16, 130, 3, 13)]
# backward kernel vs plain version. f32: max abs error over max(1, max|dqkv|),
# the same f32 products summed in another order over up to 1024 rows
# (measured 1.1e-6 to 3.6e-6 at |dqkv| < 3.6). bf16: max_rel_err (below); both
# round P and dS to bf16 before their products, where another summation
# order can round an entry of P or dS the other way, and both round dqkv
BWD_TOL = 1e-4
# bf16 gate of both kernels: every entry's error over the larger of its own
# size and the RMS of its block (q, k or v columns of dqkv; out), so that each
# shape is held to its own scale. Rounding to bf16 alone moves an entry by
# up to 2^-8 of itself; on an H100 the CUDA-core kernels measured 1.08e-2 to
# 1.49e-2 (forward) and 7.5e-3 to 1.58e-2 (backward), the tensor-core
# kernels, which round the running maximum's P instead of the normalised
# one, 1.23e-2 to 2.60e-2 (forward, phase 10's small head dims the largest)
# and up to 1.44e-2 (backward) over the checked shapes (PERF.md); the limit
# is about 2.4 times the largest
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
# MNIST32 attention blocks as (T, H, C): the latent-transport AutoEncoder
# (capacity 4, latent 4 x 4 x 64) and the VAE of configs/vae/defaults.yaml
# (capacity 8, latent 1 x 1 x 128), heads by div_sqrt of the channels
SMALL_ATTN_SHAPES = [(256, 2, 2), (64, 4, 2), (16, 8, 8), (16, 4, 2), (64, 2, 2),
                     (256, 1, 1), (256, 4, 2), (64, 4, 4), (16, 8, 4), (4, 8, 8),
                     (1, 16, 16), (1, 8, 8)]
SMALL_ATTN_BATCH = 250
# the small-head-dim gate floors each entry's denominator at 2^-8 of the RMS
# of the whole tensor as well: at T=1 dq and dk are zero in exact arithmetic
# (softmax over one key), so their blocks hold rounding noise alone
SMALL_FLOOR = 2.0**-8
# Sinkhorn, the latent-transport path's settings (DiscreteTransport)
SINKHORN_PATH = dict(reg=1e-5, max_iter=1000, threshold=1e-6)
SINKHORN_SHAPES = [(1, 256, 256), (64, 256, 256), (3, 37, 200), (1, 1024, 1024)]
# fewer rows than CTAs in the kernel's cluster (CTAs with empty bands) and M
# not a multiple of 32, held by the same gates as the other off-path shapes
SINKHORN_EDGE_SHAPES = [(2, 5, 300)]
# shapes the kernel is timed at: the path's, a batch that fills the card,
# and the largest, whose rows of Cr do not all fit in the cluster; the plain
# version is timed where its checked call took less than this many seconds
SINKHORN_TIMED = [(1, 256, 256), (64, 256, 256), (1, 1024, 1024)]
SINKHORN_PLAIN_SECONDS = 3.0
# at the path's reg |Cr| reaches 1e5 and more, where an f32 ulp is 0.008, so
# exp(u + v + Cr) carries percent-level error in any implementation and two
# summation orders do not agree entry by entry (the largest difference is
# printed, not gated, but at the path's one 256 x 256 instance). Gated: equal
# iteration counts; each instance's total cost sum(C * plan) within 1e-3 of
# the plain version's, as tests/test_torch_sinkhorn.py holds the plain
# version to the JAX package (measured 0 at the path's shape, up to 6.6e-5
# at the others on an H100), and within 3e-3 over the 64 instances of
# 64 x 256 x 256, whose worst measured 8.5e-4; at 1 x 256 x 256, the path's
# shape, the largest entry difference within 1e-3 of the largest entry
# (measured 0); and the kernel's plan as close to the marginals a and b as
# the plain version's, within a quarter of the plain version's own error
SINKHORN_COST_RTOL = 1e-3
SINKHORN_BATCH_COST_RTOL = 3e-3
SINKHORN_ENTRY_TOL = 1e-3
SINKHORN_MARGINAL_SLACK = 0.25
# well-conditioned batch: costs in [0, 1] scaled per instance, reg 0.05,
# threshold 1e-2, so the instances stop at different iterations; entries
# within 1e-4 of the largest (f32 sums in other orders over 256 terms per
# iteration; measured about 1e-6 on an H100)
SINKHORN_WELL = dict(reg=0.05, max_iter=1000, threshold=1e-2)
SINKHORN_WELL_TOL = 1e-4
# H100 SXM: 16 exponentials per clock per SM on the SFUs, at most 1.98 GHz
EXP_PER_S = 16 * 132 * 1.98e9
MNIST_TRANSPORT_EPOCHS = 4
# the latent-transport gate's floor on the restored PSNR of the Gaussian and
# GMM operators after 4 epochs (tests/test_latent_transport.py, _PSNR_PERFORMANCE),
# held by the median of MNIST_TRANSPORT_RUNS runs whose weights come from
# consecutive seeds. One run is one draw of the trained model, and the
# readings move with it by more than the floor's margin: on an H100 the GMM
# read 12.63 to 14.09 dB over five fits of one seed (cuDNN's algorithms are
# not deterministic); on one such model the JAX package's GMM operator
# restored 12.74 to 13.53 dB over 8 of its own seeds and the port's 12.74 to
# 13.51, and the JAX gate's own run on the CPU read 14.06. With the kernels
# drawn as flax draws them, seeds 0-9 read Gaussian 12.47 to 20.27 dB
# (median 16.90), GMM 14.96 to 18.02 (16.34), discrete 15.03 to 16.90
# (15.98); the median of three consecutive seeds fell to 13.43 for the
# Gaussian, the median of five stayed at 16.50 or above (PERF.md §6,
# scripts/gate_spread.py)
MNIST_TRANSPORT_PSNR = 14.0
MNIST_TRANSPORT_RUNS = 5
# the fitted MNIST32 operator's test latents transported, and restored,
# through the kernel's plan and through the plain version's: max abs error
# over max(1, max |reference|), the tolerance tests/test_torch_transport.py
# holds the port's transport to jitted JAX with at the path's reg
TRANSPORT_TOL = 3e-2
MNIST_VAE_EPOCHS = 10
# global-norm gradient clipping of the MNIST32 VAE fit. The config's recipe
# (Adam at 1e-3, no clipping) from seeded weights on the synthetic digits
# spikes the prior loss by orders of magnitude, in the JAX package as in the
# port (scripts/recipe_divergence.py jax --model mnist32 --batch 250), and
# has gone non-finite on the card; clipped at 1.0 every seed measured stayed
# finite (scripts/recipe_divergence.py fit, PERF.md §6)
MNIST_VAE_CLIP = 1.0
# row-7 checks as (B, Tq, Tk, H, d, causal, mult): the FFHQ128 ViT encoder
# and decoder and the conditional CIFAR10 ViT encoder and decoder (every
# attention call of both served models), a cross shape, a ragged T with an
# odd head dim, causal, the multiplier, and causal with the multiplier at
# d = 40, 96 and 128 (the ViTs' head dim). Causal rows read the highest bf16
# max_rel_err: an early row averages few keys, so its entries are of v's size
# while the RMS that a small entry's error is divided by is that of the whole
# output, whose late rows average many keys and are smaller
BTHD_SHAPES = [(64, 1024, 1024, 4, 128, False, False), (64, 1024, 1024, 2, 128, False, False),
               (64, 19, 19, 4, 32, False, False), (64, 18, 18, 4, 32, False, False),
               (16, 77, 300, 3, 64, False, False), (16, 37, 37, 5, 13, False, False),
               (16, 200, 200, 2, 64, True, False), (16, 150, 150, 2, 96, False, True),
               (8, 129, 129, 3, 40, True, True), (8, 150, 150, 2, 96, True, True),
               (8, 150, 150, 2, 128, True, True)]
# the DAD's attention (configs/dad/defaults.yaml, batch 50, 16 tokens, dim
# 64 over 4 heads): plain (encoder, decoder), causal (the autoregressive
# stack in eval) and causal with the multiplier (its train step)
DAD_ATTN_SHAPES = [(50, 16, 16, 4, 16, False, False), (50, 16, 16, 4, 16, True, False),
                   (50, 16, 16, 4, 16, True, True)]
BTHD_SHAPES += DAD_ATTN_SHAPES
BTHD_KEEP = 0.9  # keep probability of the seeded multiplier (mask / keep)
# bf16 rows 7, 3, 8 and 4 run on the tensor cores in 64-row tiles with head
# dims padded to a multiple of 16, copied by cp.async when d is a multiple of
# 8 and by masked scalar loads otherwise; these shapes (bf16 only: f32 keeps
# the CUDA-core kernels) cross those edges: T = 1000 and 65 at d = 128
# (ragged across 64-row tiles, 65 one row past a tile), d = 16, 48, 80 and
# 112 (padded to no width or to the next 16), d = 13 (padded, scalar loads;
# causal with the multiplier, T = 130 two rows past two tiles), and causal
# with the multiplier at the FFHQ128 ViT encoder's width, T = 1024, B = 4
BTHD_TILE_SHAPES = [(4, 1000, 1000, 2, 128, False, False), (8, 65, 65, 2, 128, False, False),
                    (8, 100, 100, 2, 16, False, False), (8, 100, 130, 2, 48, False, True),
                    (8, 100, 100, 2, 80, True, False), (8, 100, 100, 2, 112, False, False),
                    (8, 130, 130, 2, 13, True, True), (4, 1024, 1024, 4, 128, True, True)]
# rows 7 and 3 take the gates of row 1 (BF16_REL_TOL, OUT_TOL, LSE_TOL); on an
# H100 the tensor-core kernel (bf16) read max_rel_err 1.13e-2 to 3.41e-2
# (causal with the multiplier at T = 1024, d = 128 the largest) and the
# CUDA-core kernel (f32) max abs 6.0e-7 to 1.7e-6 over these shapes (PERF.md)
# the conditional CIFAR10 ViT VAE of configs/vae/vit.yaml
CIFAR_VIT_ENCODER = dict(image_size=32, patch_size=8, dim=128, depth=3, heads=4,
                         channels=3, num_classes=10, n_embed_tokens=2,
                         output_tokens="embed", patch_to_embed=True, embed_to_patch=False)
CIFAR_VIT_DECODER = dict(image_size=32, patch_size=8, dim=128, depth=3, heads=4,
                         channels=3, num_classes=10, n_embed_tokens=None, n_input_tokens=1,
                         output_tokens="embed", patch_to_embed=False, embed_to_patch=True)
CIFAR_VIT_PRIOR = dict(dim=(1, 128), num_classes=10, loss_coeff=0.1, reparam_dim=-2,
                       annealing_steps=1000)
# the FFHQ128 ViT VAE of configs/vae/vit_ffhq128.yaml
FFHQ_VIT_ENCODER = dict(image_size=128, patch_size=4, dim=512, depth=8, head_dim=128,
                        channels=3, dropout=0.0, n_embed_tokens=0, output_tokens="input",
                        patch_to_embed=True)
FFHQ_VIT_DECODER = dict(image_size=128, patch_size=4, dim=256, depth=8, head_dim=128,
                        channels=3, dropout=0.0, n_embed_tokens=0, n_input_tokens=1024,
                        output_tokens="input", patch_to_embed=False, embed_to_patch=True)
# a padded request's rows against the same rows of a full bucket, max abs
# error over max(1, max|output|): the same shapes run the same kernels and
# GEMM algorithms, and no row reads another, so the rows agree to rounding
PAD_TOL = 1e-5
# whole ViT path, f32 on the card (TF32 off) against the port on the CPU,
# max abs error over max(1, max|output|): the same function with sums in
# other orders through 6 (CIFAR10) and 16 (FFHQ128) post-LN blocks
# (measured 6.6e-7 and 5.4e-7 on an H100)
VIT_PATH_TOL = 1e-4
# the FFHQ128 ViT as served (bf16 activations, f32 parameters), card against
# the port's bf16 path on the CPU, max abs and RMS error over max(1,
# max|output|): every layer rounds its output to bf16 (2^-8 of itself), and
# sums in other orders round some entries the other way, through 16 post-LN
# blocks. On an H100 they read 7.8e-3 and 1.3e-3 at an output range of 0.875
# (PERF.md); the limits are about four times that
VIT_BF16_PATH_TOL = 3e-2
VIT_BF16_PATH_RMS_TOL = 5e-3
# row-8 and row-4 checks as (B, Tq, Tk, H, d, causal, mult): the two ViTs'
# four train shapes (the FFHQ128 ViT's encoder and decoder at batch 32, the
# conditional CIFAR10 ViT's at batch 50 with the seeded multiplier that its
# dropout of 0.1 draws), a cross shape, a ragged T with an odd head dim,
# causal, and causal with the multiplier at d = 96 and 128. Both kernels take
# the gates of row 2: bf16 max_rel_err (BF16_REL_TOL, with phase 10's RMS
# floor) over each of dq, dk and dv, and f32 max abs error over max(1,
# max|grad|) (BWD_TOL). On an H100 the tensor-core kernels (bf16) read
# max_rel_err up to 1.03e-2 (causal at d = 64) and the CUDA-core kernels
# (f32) max abs error up to 3.4e-6 (PERF.md)
BWD_BTHD_SHAPES = [(32, 1024, 1024, 4, 128, False, False),
                   (32, 1024, 1024, 2, 128, False, False),
                   (50, 19, 19, 4, 32, False, True), (50, 18, 18, 4, 32, False, True),
                   (16, 77, 300, 3, 64, False, False), (16, 37, 37, 5, 13, False, False),
                   (16, 200, 200, 2, 64, True, False), (8, 150, 150, 2, 96, True, True),
                   (8, 150, 150, 2, 128, True, True)] + DAD_ATTN_SHAPES
VIT_TRAIN_BATCH = 32  # configs/vae/vit_ffhq128.yaml
CIFAR_TRAIN_BATCH = 50  # configs/vae/vit.yaml
# Adam's learning rate of the gated fits: the configs' (the model's default)
CIFAR_TRAIN_LR = 1e-3
VIT_TRAIN_LR = 1e-3
# the CIFAR10 ViT fit: one epoch of 12000 seeded synthetic images at batch 50
CIFAR_TRAIN_IMAGES = 12000
# the trained CIFAR10 ViT's checkpoint served against the in-memory model,
# max abs error over max(1, max|output|): the same weights, shapes and
# kernels, and no cuDNN algorithm choice on the ViT path
CIFAR_CKPT_TOL = 1e-5
# the conditional CIFAR10 ViT gate (tests/test_conditional_vit_vae.py): its
# epochs and its floors on the test and the transported PSNR
CIFAR_TRANSPORT_EPOCHS = 8
CIFAR_TRANSPORT_PSNR = 14.5
# the OT core at the MNIST32 gate's shapes: the Gaussian operator over the
# whole 4 x 4 x 64 latent, about 900 validation samples a side, and the
# GMM's per-pixel channel vectors
# the AutoDiffusion gate (tests/test_auto_diffusion.py): 4 epochs of 3000
# seeded synthetic MNIST32 digits at batch 50, final-epoch validation, 5
# sampler steps; the JAX gate's floor of 15 dB (the JAX package read 17.3 dB
# on the TPU, test_auto_diffusion.py:22-25)
AD_EPOCHS = 4
AD_PSNR = 15.0
AD_N_STEPS = 5
# the gate's reading is mostly its initial weights' draw. On the CPU the JAX
# package's gate read a median of 15.69 dB over its trainer seeds 42 and
# 0-11, and the port on an H100, trained from those 13 seeds' JAX-drawn
# weights, a median of 15.28 (the paired differences' median 0.0 dB, 7 of
# 13 above the floor in each); seed 4's weights read 14.3 to 15.0 dB through
# the port under five trainer seeds, the JAX gate's own (seed 42's) 15.67 to
# 18.74 dB under 18 of 19 trainer seeds, and below -100 dB twice under
# trainer seed 42 (PERF.md §6, scripts/auto_diffusion_spread.py,
# scripts/gate_spread.py). So phase 28 trains the JAX gate's own initial
# weights, drawn by jax_init, and holds the unchanged floor by the median
# of AD_RUNS runs under trainer seeds 42 + s .. 46 + s; every run is printed
AD_WEIGHTS_SEED = 42
AD_RUNS = 5
# the DAD gate (tests/test_dad.py, the model of configs/dad/defaults.yaml
# with dropout 0.1): 8 epochs of 2500 seeded synthetic 28² digits at batch
# 50, final-epoch validation; the JAX gate's floor of 13 dB (13.8 dB on the
# TPU, test_dad.py:18)
DAD_EPOCHS = 8
DAD_PSNR = 13.0
# the KV-cached DAD sampler against the unrolled oracle for one generator
# (tests/test_dad.py holds the JAX pair to the same atol): the same tokens
# decode through the same kernels
DAD_SAMPLER_ATOL = 1e-5
# InferenceEngine.sample against the model's sampler for the same
# generator, max abs error over max(1, max|output|): the same calls on the
# same device
ENGINE_SAMPLE_TOL = 1e-5
OT_GAUSSIAN_DIM = 1024
OT_SAMPLES = 900
OT_GMM_DIM = 64
# f32 on the card (TF32 allowed) against the same port code in f64 on the
# CPU, max abs error over max(1, max|f64|), for T and for 64 transported
# samples of a cloud drawn like the source (its own mixing).
# T = Cs^-½·(√Cs·Ct·√Cs)^½·Cs^-½ divides by the roots of the source's
# smallest eigenvalues: with 900
# samples in 1024 dims about 125 of them sit at the shrinkage floor (1e-3
# of the mean variance, a condition number near 9e3), and a fresh sample's
# component along them is multiplied by T's largest entries. The f32
# eigendecompositions decide the error: handed the f64 sums, f32 on the
# CPU (LAPACK) reads 9.5e-3 (T) and 2.9e-2 (transported) under eigh, 4.6e-3
# and 7.5e-3 under polar; the card (cuSOLVER) read 3.1e-2 and 5.4e-2
# under eigh, 8.5e-3 and 1.3e-2 under polar (PERF.md §6)
OT_T_TOL = {"eigh": 1e-1, "polar": 5e-2}
# W2² sums traces of roots, which f32 rounding moves by far less
OT_COST_RTOL = 1e-3
# the Newton–Schulz roots (30 coupled iterations, 2 refinements) in f32
# against the same iterations in f64, on the fitted covariance
OT_NS_TOL = 5e-2
# the GMM coupling runs Sinkhorn at reg 1e-5 on costs scaled to [0, 1]:
# |Cr| reaches 1e5, where an f32 ulp is 0.008, so its plan and MW2 carry
# percent-level error in f32 (phase 11); the transported samples, routed by
# the plan's largest entry and moved by diagonal operators, agree to f32
# rounding where the routes agree
OT_PLAN_TOL = 2e-2
OT_GMM_TOL = 1e-3

# rows 5 and 6 (the fused attention block) checks as (T, H, ch, C, C_out,
# batch of the forward check, batch of the backward check): the FFHQ128
# model's six blocks (C = C_out = H·64) at the serving and the train batch,
# the MNIST32 shapes with C = C_out = H·ch, a ragged T with C, H·ch and C_out
# all different, and one head of 128 dims. The weights arrive as the model
# hands them (transposed views of the convs' [out, in] weights), but for the
# ragged shapes, which take the JAX package's contiguous [in, out] layout.
# Both kernels take the gates of rows 1 and 2: bf16 max_rel_err
# (BF16_REL_TOL, with phase 10's floor) over out, dx, each of the q, k and v
# column blocks of dW_qkv, and dW_out; f32 max abs error over max(1,
# max|ref|) (OUT_TOL for out, BWD_TOL for the gradients); lse to LSE_TOL.
# Row 6 runs twice on the same inputs and must repeat bit for bit.
BLOCK_SHAPES = ([(t, h, HEAD_DIM, h * HEAD_DIM, h * HEAD_DIM, BATCH, TRAIN_BATCH)
                 for _, t, h in ATTN_SHAPES]
                + [(t, h, c, h * c, h * c, SMALL_ATTN_BATCH, SMALL_ATTN_BATCH)
                   for t, h, c in SMALL_ATTN_SHAPES]
                + [(37, 3, 8, 24, 40, 16, 16), (100, 1, 128, 128, 128, 16, 16)])
# bf16 rows 5 and 6 run their projections on the tensor cores in 128 x 128
# tiles of C, 32 deep (qkv in 64 x 64 tiles, 16 deep), and their attention
# in 64-row tiles with head dims padded to a multiple of 16; all copy a
# tile by cp.async where its rows start on 16 bytes and by masked scalar
# loads otherwise. These (T, H, ch, C, C_out, batch of the forward check,
# batch of the backward check, weights as the model's transposed views)
# cross those edges, in bf16 only
# (f32 keeps the CUDA-core kernels): T = 1000 and 65 at ch = 64 (ragged
# across 64-row tiles and across the GEMMs' 128-row tiles), ch = 16, 48 and
# 128, ch = 13 with H = 3 (H·ch = 39: qkv, attn and their head columns off
# 16 bytes), and C, H·ch and C_out all different and no multiple of 16 (C
# = 40 and C_out = 24 copied in chunks, C = 37 and C_out = 29 by scalar
# loads), in both weight layouts, and C = H·ch = C_out = 48 at T = 130 (the
# CPU test's ch = 48 shape, which takes C = 16 there). They take
# BLOCK_SHAPES' gates, and row 6 repeats bit for bit.
BLOCK_TILE_SHAPES = [(1000, 2, 64, 128, 128, 8, 8, True), (65, 2, 64, 128, 128, 16, 16, False),
                     (100, 2, 16, 32, 32, 16, 16, True), (100, 2, 48, 96, 96, 16, 16, False),
                     (100, 1, 128, 128, 128, 8, 8, True), (130, 3, 13, 40, 24, 16, 16, False),
                     (77, 2, 24, 37, 29, 8, 8, True), (130, 1, 48, 48, 48, 16, 16, True)]

class CheckFailed(Exception):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise CheckFailed(what)


def max_rel_err(got: torch.Tensor, ref: torch.Tensor, blocks: int,
                floor: float = 0.0) -> float:
    """max |got − ref| / max(|ref|, rms, floor·RMS of ``ref``), entry by
    entry, where rms is that of the entry's block: the last dim of ``ref``
    split into ``blocks`` equal parts (q, k and v of a packed tensor), over
    all other dims."""
    ref = ref.float()
    parts = ref.view(*ref.shape[:-1], blocks, ref.shape[-1] // blocks)
    dims = tuple(range(parts.dim() - 2)) + (parts.dim() - 1,)
    rms = parts.square().mean(dim=dims, keepdim=True).sqrt()
    rms = torch.clamp_min(rms, floor * ref.square().mean().sqrt().item())
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
    """Kernel against its plain version at the path's shapes and, in bf16,
    the tile and alignment shapes; times at the T=1024 and T=256 shapes in
    bf16, the path's dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    scale = 1.0 / math.sqrt(HEAD_DIM)
    worst = {}
    path = [(BATCH, t, h, HEAD_DIM) for t, h in sorted({(t, h) for _, t, h in ATTN_SHAPES})]
    for dtype in (torch.bfloat16, torch.float32):
        for b, t, h, c in path + (PACKED_TILE_SHAPES if dtype == torch.bfloat16 else []):
            qkv = torch.randn((b, t, 3 * h * c), generator=gen, device="cuda").to(dtype)
            out, lse = attention.attention_packed(qkv, h, 1.0 / math.sqrt(c))
            torch.cuda.synchronize()
            ref_out, ref_lse = attention.attention_packed_reference(qkv, h, 1.0 / math.sqrt(c))
            err = (out.float() - ref_out.float()).abs().max().item()
            rel = max_rel_err(out, ref_out, 1)
            lse_err = (lse - ref_lse).abs().max().item()
            name = str(dtype).replace("torch.", "")
            gate = (f"max_rel_err={rel:.3e} (tol {BF16_REL_TOL:.1e})"
                    if dtype == torch.bfloat16 else f"(tol {OUT_TOL:.1e})")
            print(f"kernel check {name} B={b} T={t} H={h} C={c}: "
                  f"out max_abs_err={err:.3e} {gate} "
                  f"lse max_abs_err={lse_err:.3e} (tol {LSE_TOL:.1e})", flush=True)
            ok = rel <= BF16_REL_TOL if dtype == torch.bfloat16 else err <= OUT_TOL
            check(math.isfinite(err) and ok, f"attention out {name} T={t} H={h} C={c}: "
                                             f"abs {err}, rel {rel}")
            check(math.isfinite(lse_err) and lse_err <= LSE_TOL,
                  f"attention lse {name} T={t} H={h} C={c}: {lse_err}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            del qkv, out, lse, ref_out, ref_lse

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
        timings[(t, h)] = _with_shares(row)
        print(f"kernel time bf16 B={BATCH} T={t} H={h} C={HEAD_DIM}: "
              f"kernel {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}; share {row['bound_share']:.4f}), plain "
              f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms (kernel "
              f"{row['library_factor']:.2f}x); {flops / row['ms'] / 1e9:.1f} TFLOP/s",
              flush=True)
    del flush
    return worst, timings


def ffhq128_vae(dtype, seed: int, fused_block: bool = False):
    """The FFHQ128 CNN VAE of configs/vae/ffhq128.yaml (prior loss
    coefficient 0.1, PSNR metric, Adam at the model's default 1e-3),
    weights from ``seed``; ``fused_block`` runs its six attention blocks
    through the fused block (rows 5 and 6) with the same parameters."""
    from ot_vae_tpu_torch.data import ffhq128_transforms
    from ot_vae_tpu_torch.metrics import PSNR, MetricCollection
    from ot_vae_tpu_torch.models import VAE
    from ot_vae_tpu_torch.networks import CNN
    from ot_vae_tpu_torch.priors import GaussianPrior

    torch.manual_seed(seed)
    model = VAE(
        CNN(3, 512, 128, 4, capacity=64, down_sample=True, residual="add",
            attn_head_dim=64, dtype=dtype, fused_block=fused_block),
        CNN(256, 3, 4, 128, capacity=64, up_sample=True, residual="add",
            attn_head_dim=64, dtype=dtype, fused_block=fused_block),
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


def _attention_counts(attention, sinkhorn):
    """Every kernel counter, by row: 1 and 2 (packed), 5 and 6 (fused block),
    7, 3, 8 and 4 (BTHD/BHTC), 9 (Sinkhorn)."""
    return {1: attention.launch_count, 2: attention.backward_launch_count,
            5: attention.block_launch_count, 6: attention.block_bwd_launch_count,
            7: attention.bthd_launch_count, 3: attention.bhtc_launch_count,
            8: attention.bthd_bwd_launch_count, 4: attention.bhtc_bwd_launch_count,
            9: sinkhorn.launch_count}


def phase_serve(attention, sinkhorn, seed: int, fused: bool = False):
    """The engine's four endpoints at full width: the unfused model through
    row 1, or with ``fused`` the fused-block model through row 5 (and no
    launch of any other kernel)."""
    from ot_vae_tpu_torch.serving import InferenceEngine

    row = 5 if fused else 1
    model = ffhq128_vae(torch.bfloat16, seed, fused).to("cuda",
                                                         memory_format=torch.channels_last)
    calibrate_batch_norm(model, seed)
    engine = InferenceEngine(model, batch_sizes=(1, 8, 64))
    rng = np.random.default_rng(seed)
    images = {n: rng.uniform(0, 1, (n, 128, 128, 3)).astype(np.float32)
              for n in (1, 5, 8, 64)}
    expected = {"reconstruct": 6, "encode": 3, "decode": 3, "sample": 3}

    attention.launch_count = attention.block_launch_count = 0
    before = _attention_counts(attention, sinkhorn)
    seen = 0

    def request(kind, fn, shape):
        nonlocal seen
        out = fn()
        torch.cuda.synchronize()
        count = _attention_counts(attention, sinkhorn)[row]
        launched, seen = count - seen, count
        check(out.shape == shape, f"{kind}: shape {out.shape} != {shape}")
        check(bool(np.isfinite(out).all()), f"{kind}: non-finite output")
        check(launched == expected[kind],
              f"{kind}: row {row} launched {launched} times, expected {expected[kind]}")
        return out

    for n in (1, 5, 64):
        request("reconstruct", lambda: engine.reconstruct(images[n]), (n, 128, 128, 3))
    z = request("encode", lambda: engine.encode(images[8]), (8, 4, 4, 256))
    request("decode", lambda: engine.decode(z), (8, 128, 128, 3))
    request("sample", lambda: engine.sample(8), (8, 128, 128, 3))
    after = _attention_counts(attention, sinkhorn)
    launches = after[row]
    check(launches == 27, f"main path launched row {row} {launches} times, expected 27")
    others = {r: after[r] - before[r] for r in after if r != row}
    check(not any(others.values()), f"the serving path launched other kernels: {others}")
    name = "fused block" if fused else "attention kernel"
    print(f"serve FFHQ128{' fused block' if fused else ''} bf16 full width: reconstruct "
          f"1/5/64, encode 8, decode 8, sample 8 ok; {name} (row {row}) launches {launches}; "
          f"other kernels {others}", flush=True)

    z64 = engine.encode(images[64])
    rates = _serve_rates({"reconstruct": lambda: engine.reconstruct(images[64]),
                          "encode": lambda: engine.encode(images[64]),
                          "decode": lambda: engine.decode(z64),
                          "sample": lambda: engine.sample(64)}, 64)
    print(f"serve{' fused block' if fused else ''} img/s at bucket 64 (bf16): " + ", ".join(
        f"{k} {v:.1f}" for k, v in rates.items()), flush=True)
    return launches, engine, rates, others


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
    shapes (B=128), two ragged ones and, in bf16, the tile and alignment
    shapes, every bf16 check twice and bit for bit; times at the T=1024 and
    T=256 shapes in bf16, the path's dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4321)
    shapes = [(TRAIN_BATCH, t, h, c) for t, h, c in
              [(t, h, HEAD_DIM) for t, h in sorted({(t, h) for _, t, h in ATTN_SHAPES})]
              + RAGGED_SHAPES]
    worst = {}
    repeats = 0
    for dtype in (torch.bfloat16, torch.float32):
        for b, t, h, c in shapes + (PACKED_TILE_SHAPES if dtype == torch.bfloat16 else []):
            scale = 1.0 / math.sqrt(c)
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
            if dtype == torch.bfloat16:
                again = attention.attention_packed_backward(qkv, out, lse, dout, h, scale)
                check(torch.equal(dqkv, again),
                      f"attention backward B={b} T={t} H={h} C={c}: a second run differs")
                repeats += 1
                del again
            del qkv, dout, out, lse, dqkv, ref
    print(f"attention backward bf16: {repeats} checks repeated bit for bit", flush=True)

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
        timings[(t, h)] = _with_shares(row)
        print(f"backward time bf16 B={b} T={t} H={h} C={c}: kernel {row['ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; share "
              f"{row['bound_share']:.4f}), plain {row['plain_ms']:.4f} ms, sdpa backward "
              f"{row['library_ms']:.4f} ms (kernel {row['library_factor']:.2f}x); "
              f"fwd+bwd: port {row['fwd_bwd_ms']:.4f} ms, sdpa "
              f"{row['sdpa_fwd_bwd_ms']:.4f} ms; {flops / row['ms'] / 1e9:.1f} TFLOP/s",
              flush=True)
        del qkv, dout, out, lse, q, k, v, dout_bhtc, sdpa_out, x
    del flush
    return worst, timings


class _Recorder:
    """Logger keeping every logged row and image."""

    def __init__(self):
        self.rows = []
        self.images = []

    def log_metrics(self, metrics, step):
        self.rows.append((step, dict(metrics)))

    def log_image(self, name, grid, step):
        self.images.append((name, np.asarray(grid)))


def phase_train(attention, sinkhorn, seed: int, workdir: Path, fused: bool = False):
    """Trainer.fit at full width, batch 128: the unfused model through rows
    1 and 2, or with ``fused`` the fused-block model through rows 5 and 6
    (and no launch of any other kernel)."""
    from ot_vae_tpu_torch.data import FFHQ128
    from ot_vae_tpu_torch.trainer import Callback, ModelCheckpointCallback, Trainer

    rows = (5, 6) if fused else (1, 2)

    class StepProbe(Callback):
        """Synchronises after each step and records the time, the path's
        forward and backward counters and the dout copies."""

        def __init__(self):
            self.rows = []

        def _record(self):
            torch.cuda.synchronize()
            counts = _attention_counts(attention, sinkhorn)
            self.rows.append((time.perf_counter(), counts[rows[0]], counts[rows[1]],
                              attention.dout_copies))

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
    model = ffhq128_vae(torch.bfloat16, seed, fused)
    model.learning_rate = TRAIN_LR
    probe, logger = StepProbe(), _Recorder()
    ckpt = ModelCheckpointCallback(dirpath=str(workdir / "checkpoints"))
    trainer = Trainer(max_epochs=1, limit_batches=TRAIN_STEPS, log_every_n_steps=1,
                      callbacks=[probe, ckpt], logger=logger, seed=seed)
    torch.cuda.reset_peak_memory_stats()
    attention.launch_count = attention.backward_launch_count = attention.dout_copies = 0
    attention.block_launch_count = attention.block_bwd_launch_count = 0
    before = _attention_counts(attention, sinkhorn)
    trainer.fit(model, dm)
    torch.cuda.synchronize()
    after = _attention_counts(attention, sinkhorn)
    launches = {"forward": after[rows[0]], "backward": after[rows[1]]}
    others = {r: after[r] - before[r] for r in after if r not in rows}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    name = "FFHQ128 fused block" if fused else "FFHQ128"
    losses = [m["train/loss/total"] for _, m in logger.rows if "train/loss/total" in m]
    print(f"train {name} losses per step (total, recon, prior): " + ", ".join(
        f"({m['train/loss/total']:.4g}, {m['train/loss/recon']:.4g}, "
        f"{m['train/loss/prior']:.4g})" for _, m in logger.rows if "train/loss/total" in m),
        flush=True)
    psnr = trainer.logged_metrics.get("val/metrics/psnr", float("nan"))
    check(len(losses) == TRAIN_STEPS, f"train {name}: {len(losses)} losses logged")
    check(all(math.isfinite(v) for v in losses), f"train {name}: non-finite loss in {losses}")
    check(losses[-1] < losses[0],
          f"train {name}: loss did not fall ({losses[0]} -> {losses[-1]})")
    check(math.isfinite(psnr), f"train {name}: validation PSNR {psnr}")
    check(not any(others.values()), f"train {name}: other kernels launched {others}")
    steps = [(b[1] - a[1], b[2] - a[2], b[3] - a[3])
             for a, b in zip(probe.rows[:-1], probe.rows[1:])]
    check(len(steps) == TRAIN_STEPS, f"train {name}: {len(steps)} steps probed")
    bad = [i for i, (f, b, _) in enumerate(steps) if (f, b) != (6, 6)]
    check(not bad, f"train {name}: steps {bad} launched (row {rows[0]}, row {rows[1]}) "
                   f"{[steps[i][:2] for i in bad]}, expected (6, 6)")
    # a validation batch runs the forward (6 blocks); the eval step's
    # latents come from the same encoder pass
    val_batches = min(TRAIN_STEPS, dm.steps_per_epoch("val"))
    check(launches == {"forward": 6 * TRAIN_STEPS + 6 * val_batches,
                       "backward": 6 * TRAIN_STEPS},
          f"train {name}: kernel launches {launches}")
    check(ckpt.best_path is not None, f"train {name}: no checkpoint saved")
    times = [r[0] for r in probe.rows]
    steady = 3  # steps 4..20: from the end of step 3 to the end of step 20
    img_s = (TRAIN_STEPS - steady) * TRAIN_BATCH / (times[-1] - times[steady])
    copies = sum(s[2] for s in steps) / TRAIN_STEPS
    print(f"train {name} bf16 full width, batch {TRAIN_BATCH}, lr {TRAIN_LR:g}: "
          f"{TRAIN_STEPS} steps, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, val PSNR {psnr:.3f} dB; "
          f"launches per step 6 row {rows[0]} + 6 row {rows[1]} (run: {launches}; other "
          f"kernels {others}); steady train img/s (steps 4-{TRAIN_STEPS}, synchronised) "
          f"{img_s:.1f}; peak memory {peak_gib:.2f} GiB; dout copies per step {copies:.1f}; "
          f"synthetic data {data_s:.1f} s", flush=True)
    stats = {"img_s": img_s, "peak_gib": peak_gib, "copies": copies, "others": others}
    return model, ckpt.best_path, launches, stats


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


def _check_train_runs(name, runs):
    """Losses of the card's run against the CPU's (TRAIN_LOSS_RTOL), and the
    first step's gradients of both against the f64 run (GRAD_RTOL of a
    leaf's norm; leaves with no gradient in exact arithmetic within
    GRAD_NOISE_TOL of the largest)."""
    (card_l, card_g), (cpu_l, cpu_g), (_, exact) = runs["card"], runs["cpu"], runs["cpu64"]
    loss_err = [abs(a - b) / max(1.0, abs(b)) for a, b in zip(card_l, cpu_l)]
    scale = max(g.abs().max().item() for g in exact.values())
    worst = {"card": (0.0, ""), "cpu": (0.0, "")}
    n_noise, card_cpu = 0, 0.0
    for leaf, g in exact.items():
        noise = g.abs().max().item() <= GRAD_NOISE * scale
        n_noise += noise
        if not noise:
            card_cpu = max(card_cpu, (card_g[leaf] - cpu_g[leaf]).norm().item() / g.norm().item())
        for side, grads in (("card", card_g), ("cpu", cpu_g)):
            if noise:
                ratio = grads[leaf].abs().max().item() / (GRAD_NOISE_TOL * scale)
            else:
                ratio = (grads[leaf] - g).norm().item() / (GRAD_RTOL * g.norm().item())
            worst[side] = max(worst[side], (ratio, leaf))
    print(f"train card vs CPU f32, {name}, batch 4, 2 steps: losses card {card_l} cpu "
          f"{cpu_l} (rel err {loss_err[0]:.3e}, {loss_err[1]:.3e}; tol "
          f"{TRAIN_LOSS_RTOL[0]:.0e}, {TRAIN_LOSS_RTOL[1]:.0e}); first step gradients vs "
          f"f64 (tol {GRAD_RTOL:.0e} of a leaf's norm): card worst "
          f"{worst['card'][0] * GRAD_RTOL:.3e} at {worst['card'][1]}, CPU worst "
          f"{worst['cpu'][0] * GRAD_RTOL:.3e} at {worst['cpu'][1]}; card vs CPU up to "
          f"{card_cpu:.3e}; {n_noise} leaves with no gradient in exact arithmetic", flush=True)
    check(all(math.isfinite(v) for v in card_l)
          and all(e <= t for e, t in zip(loss_err, TRAIN_LOSS_RTOL)),
          f"train card vs CPU {name}: losses {card_l} vs {cpu_l}")
    for side, (ratio, leaf) in worst.items():
        check(ratio <= 1.0, f"train {name} {side} vs f64: gradient {leaf} off by "
                            f"{ratio:.3f}x tol")


def phase_train_card_vs_cpu(seed: int, fused: bool = False):
    """Two train steps at full width, batch 4, from the same weights and ε:
    f32 on the card, f32 and f64 on the CPU (with ``fused``, the fused-block
    model: rows 5 and 6 on the card, their plain versions on the CPU)."""
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
        model = ffhq128_vae(dtype, seed + 3, fused)
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
    _check_train_runs("FFHQ128 CNN fused block" if fused else "FFHQ128 CNN", runs)


def phase_small_heads(attention):
    """Both attention kernels against their plain versions at the MNIST32
    models' attention shapes, head dims 1 to 16, bf16 and f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2468)
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        for t, h, c in SMALL_ATTN_SHAPES:
            b, scale = SMALL_ATTN_BATCH, 1.0 / math.sqrt(c)
            qkv = torch.randn((b, t, 3 * h * c), generator=gen, device="cuda").to(dtype)
            dout = torch.randn((b, t, h * c), generator=gen, device="cuda").to(dtype)
            out, lse = attention.attention_packed(qkv, h, scale)
            dqkv = attention.attention_packed_backward(qkv, out, lse, dout, h, scale)
            torch.cuda.synchronize()
            ref_out, ref_lse = attention.attention_packed_reference(qkv, h, scale)
            ref = attention.attention_packed_backward_reference(qkv, out, lse, dout, h, scale)
            errs = {"out": (out.float() - ref_out.float()).abs().max().item(),
                    "lse": (lse - ref_lse).abs().max().item(),
                    "dqkv": (dqkv.float() - ref.float()).abs().max().item()}
            rel = (max_rel_err(out, ref_out, 1, SMALL_FLOOR),
                   max_rel_err(dqkv, ref, 3, SMALL_FLOOR))
            if dtype == torch.bfloat16:
                gate = f"max_rel_err out {rel[0]:.3e} dqkv {rel[1]:.3e} (tol {BF16_REL_TOL:.1e})"
                ok = max(rel) <= BF16_REL_TOL
            else:
                tols = (OUT_TOL, BWD_TOL * max(1.0, ref.float().abs().max().item()))
                gate = f"(tol out {tols[0]:.1e}, dqkv {tols[1]:.3e})"
                ok = errs["out"] <= tols[0] and errs["dqkv"] <= tols[1]
            print(f"small-head check {name} B={b} T={t} H={h} C={c}: max_abs_err out "
                  f"{errs['out']:.3e} lse {errs['lse']:.3e} (tol {LSE_TOL:.1e}) dqkv "
                  f"{errs['dqkv']:.3e} {gate}", flush=True)
            check(all(math.isfinite(v) for v in errs.values()) and ok
                  and errs["lse"] <= LSE_TOL,
                  f"attention small heads {name} T={t} H={h} C={c}: {errs}, rel {rel}")
            for key in ("out", "dqkv"):
                worst[(key, dtype)] = max(worst.get((key, dtype), 0.0), errs[key])
            del qkv, dout, out, lse, dqkv, ref, ref_out, ref_lse
    return worst


def codebook_costs(batch: int, n: int, m: int, dim: int, seed: int):
    """(a, b, cost) as DiscreteTransport.compute builds them: the weights of
    two seeded codebooks (from observation counts) and 1 / (energy + 1e-8)
    between their atoms, energy being the euclidean codebook energy."""
    from ot_vae_tpu_torch.distributions import CodebookModel, CodebookState

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def codebook(k, spread):
        return CodebookState(
            codebook=torch.randn((batch, k, dim), generator=gen, device="cuda") * spread,
            n_obs=torch.rand((batch, k), generator=gen, device="cuda") * 20.0,
            s1=torch.zeros((batch, k, dim), device="cuda"), initialized=True)

    source, target = codebook(n, 1.0), codebook(m, 1.3)
    model = CodebookModel(leading_shape=(batch,), dim=dim, n_components=max(n, m))
    cost = 1.0 / (model.energy(target.codebook, source.codebook) + 1e-8)
    return model.weights(source), model.weights(target), cost


def phase_sinkhorn(sinkhorn):
    """The Sinkhorn kernel against its plain version; its times at
    SINKHORN_TIMED. Returns the largest entry difference and the timings by
    shape."""
    worst, rows = 0.0, {}
    for batch, n, m in SINKHORN_SHAPES + SINKHORN_EDGE_SHAPES:
        lp = sinkhorn._launch_plan(n, m)
        print(f"sinkhorn plan N={n} M={m}: cluster {lp.cluster}, {lp.rows} rows a CTA, "
              f"{lp.resident} resident, {lp.streamed} streamed, {lp.slices} row-pass "
              f"slices, {lp.smem_bytes} bytes of shared memory a CTA; "
              f"{sinkhorn.active_clusters(n, m)} clusters at once", flush=True)
        a, b, cost = codebook_costs(batch, n, m, 16, seed=batch * 7919 + n)
        got = sinkhorn.sinkhorn_log_kernel(a, b, cost, return_extra=True, **SINKHORN_PATH)
        torch.cuda.synchronize()
        start = time.perf_counter()
        want = sinkhorn.sinkhorn_log_kernel_reference(a, b, cost, return_extra=True,
                                                      **SINKHORN_PATH)
        torch.cuda.synchronize()
        plain_seconds = time.perf_counter() - start
        diff = (got.plan - want.plan).abs().max().item()
        top = want.plan.abs().max().item()
        marg = {}
        for side, plan in (("kernel", got.plan), ("plain", want.plan)):
            marg[side] = ((plan.sum(-1) - a).abs().max().item(),
                          (plan.sum(-2) - b).abs().max().item())
        totals = [(cost * plan).sum((-2, -1)) for plan in (got.plan, want.plan)]
        cost_err = ((totals[0] - totals[1]).abs() / totals[1].abs()).max().item()
        gated = (batch, n, m) == (1, 256, 256)
        cost_tol = SINKHORN_BATCH_COST_RTOL if batch == 64 else SINKHORN_COST_RTOL
        iters = (got.num_iters.tolist(), want.num_iters.tolist())
        print(f"sinkhorn check B={batch} N={n} M={m} reg 1e-5: iterations kernel "
              f"{sorted(set(iters[0]))} plain {sorted(set(iters[1]))}, last err up to "
              f"kernel {got.err.max().item():.4g} plain {want.err.max().item():.4g} "
              f"(threshold 1e-6); total cost rel err {cost_err:.3e} (tol "
              f"{cost_tol:.0e}); marginal error "
              f"rows/cols kernel {marg['kernel'][0]:.3e}/{marg['kernel'][1]:.3e} plain "
              f"{marg['plain'][0]:.3e}/{marg['plain'][1]:.3e} (a, b up to "
              f"{a.max().item():.3e}, {b.max().item():.3e}); largest entry difference "
              f"{diff:.3e} of {top:.3e} "
              + (f"(tol {SINKHORN_ENTRY_TOL:.0e} of the largest)" if gated else "(not gated)"),
              flush=True)
        check(iters[0] == iters[1], f"sinkhorn B={batch} N={n} M={m}: iterations {iters}")
        check(bool(torch.isfinite(got.plan).all()), f"sinkhorn B={batch}: non-finite plan")
        check(cost_err <= cost_tol,
              f"sinkhorn B={batch} N={n} M={m}: total cost rel err {cost_err}")
        check(not gated or diff <= SINKHORN_ENTRY_TOL * top,
              f"sinkhorn B={batch} N={n} M={m}: largest entry difference {diff} of {top}")
        for k in range(2):
            limit = marg["plain"][k] * (1 + SINKHORN_MARGINAL_SLACK) + 1e-7
            check(marg["kernel"][k] <= limit,
                  f"sinkhorn B={batch} N={n} M={m}: marginal {k} {marg['kernel'][k]} > {limit}")
        worst = max(worst, diff)
        if (batch, n, m) in SINKHORN_TIMED:
            flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
            exps = 2.0 * n * m * int(got.num_iters.sum())
            bytes_ms = (2 * cost.numel() + a.numel() + b.numel()) * 4 / HBM_BYTES_PER_S * 1e3
            ops_ms = exps / EXP_PER_S * 1e3
            row = {
                "ms": time_ms(lambda: sinkhorn.sinkhorn_log_kernel(a, b, cost, **SINKHORN_PATH),
                              flush, reps=10),
                "plain_ms": (time_ms(lambda: sinkhorn.sinkhorn_log_kernel_reference(
                    a, b, cost, **SINKHORN_PATH), flush, reps=3)
                    if plain_seconds < SINKHORN_PLAIN_SECONDS else None),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
                "library_ms": None,
                "iters": int(got.num_iters.sum()),
            }
            rows[(batch, n, m)] = row
            del flush
            plain = (f"plain {row['plain_ms']:.4f} ms" if row["plain_ms"] is not None else
                     f"plain not timed (its check took {plain_seconds:.1f} s)")
            print(f"sinkhorn time f32 B={batch} N={n} M={m}, {row['iters']} iterations in all: "
                  f"kernel {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}: {exps:.3e} exponentials; share "
                  f"{row['bound_ms'] / row['ms']:.4f}), {plain}; no single PyTorch call "
                  f"computes Sinkhorn", flush=True)
        del a, b, cost, got, want

    gen = torch.Generator(device="cuda").manual_seed(97)
    scales = torch.tensor([1.0, 0.5, 0.25, 0.1], device="cuda")
    cost = torch.rand((4, 256, 256), generator=gen, device="cuda") * scales[:, None, None]
    a = torch.full((4, 256), 1.0 / 256, device="cuda")
    b = torch.rand((4, 256), generator=gen, device="cuda") + 0.5
    b = b / b.sum(-1, keepdim=True)
    got = sinkhorn.sinkhorn_log_kernel(a, b, cost, return_extra=True, **SINKHORN_WELL)
    want = sinkhorn.sinkhorn_log_kernel_reference(a, b, cost, return_extra=True,
                                                  **SINKHORN_WELL)
    rel = ((got.plan - want.plan).abs().max() / want.plan.abs().max()).item()
    iters = (got.num_iters.tolist(), want.num_iters.tolist())
    print(f"sinkhorn check well-conditioned B=4 N=M=256 reg 0.05 threshold 1e-2: "
          f"iterations kernel {iters[0]} plain {iters[1]}; max_abs_err over the largest "
          f"entry {rel:.3e} (tol {SINKHORN_WELL_TOL:.0e})", flush=True)
    check(iters[0] == iters[1] and len(set(iters[0])) > 1,
          f"sinkhorn well-conditioned: iterations {iters} (must agree and differ)")
    check(rel <= SINKHORN_WELL_TOL, f"sinkhorn well-conditioned: {rel}")
    return worst, rows


def mnist32_transport_model():
    """The latent-transport gate's model: the AutoEncoder (capacity 4,
    latent 4 x 4 x 64, residual add), no prior, PSNR."""
    from ot_vae_tpu_torch.metrics import PSNR, MetricCollection
    from ot_vae_tpu_torch.models import VAE
    from ot_vae_tpu_torch.networks import AutoEncoder

    ae = AutoEncoder(1, 64, 32, 4, capacity=4, down_up_sample=True, residual="add")
    return VAE(metrics=MetricCollection({"psnr": PSNR()}), autoencoder=ae, prior=None)


def mnist32_transports(model, device="cuda"):
    """The latent-transport gate's three callbacks
    (tests/test_latent_transport.py): the whole 4 x 4 x 64 latent by a
    Gaussian operator (D = 1024), each pixel's channel vector by a GMM of 10
    diagonal components, each channel's 4 x 4 map by a 256-atom codebook;
    one operator each for all positions, blur degradation, 4 samples in
    each collage."""
    from ot_vae_tpu_torch.data import GaussianBlur
    from ot_vae_tpu_torch.transport import (
        DiscreteTransport,
        GaussianTransport,
        GMMTransport,
        LatentTransport,
    )

    common = dict(size=model.latent_size, transformations=GaussianBlur(5, sigma=1.5),
                  common_operator=True, unpaired=True, num_samples_to_log=4, device=device)
    return {
        "gaussian": LatentTransport(
            transport_dims=(1, 2, 3), transport_operator=GaussianTransport,
            logging_prefix="gaussian", operator_kwargs=dict(diag=False, make_pd=True),
            **common),
        "gmm": LatentTransport(
            transport_dims=(3,), transport_operator=GMMTransport, logging_prefix="gmm",
            operator_kwargs=dict(diag=True, n_components=10, transport_type="argmax",
                                 kmeans_iter=0), **common),
        "discrete": LatentTransport(
            transport_dims=(1, 2), transport_operator=DiscreteTransport,
            logging_prefix="discrete",
            operator_kwargs=dict(n_components=256, transport_type="mean",
                                 training_mode="mean", temperature=1e-2, kmeans_iter=0),
            **common)}


def _check_collages(name, logger, cb, epochs, shape):
    """Every validation logged one finite collage of ``shape`` under the
    callback's prefix."""
    grids = [g for key, g in logger.images if key == cb.logging_prefix_full]
    check(len(grids) == epochs and all(g.shape == shape and bool(np.isfinite(g).all())
                                       for g in grids),
          f"{name}: collages {[g.shape for g in grids]} under {cb.logging_prefix_full}, "
          f"expected {epochs} of {shape}")


def _mnist32_gate_run(dm, seed: int, sinkhorn):
    """One run of the latent-transport gate: the model's weights from
    ``seed``, Trainer.fit for 4 epochs with the three callbacks, then
    Trainer.test; the run's checks, and (model, callbacks, restored PSNR by
    operator)."""
    from ot_vae_tpu_torch.trainer import Callback, Trainer

    class SinkhornProbe(Callback):
        """Sinkhorn launches at the end of each validation (after the
        transport callbacks' fits)."""

        def __init__(self):
            self.per_epoch = []

        def on_validation_epoch_start(self, trainer, model):
            self._start = sinkhorn.launch_count

        def on_validation_epoch_end(self, trainer, model):
            self.per_epoch.append(sinkhorn.launch_count - self._start)

    torch.manual_seed(seed)
    model = mnist32_transport_model()
    cbs, probe, logger = mnist32_transports(model), SinkhornProbe(), _Recorder()
    trainer = Trainer(max_epochs=MNIST_TRANSPORT_EPOCHS, seed=42,
                      callbacks=[*cbs.values(), probe], logger=logger, log_every_n_steps=1)
    start = time.perf_counter()
    trainer.fit(model, dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - start
    test = trainer.test(model, dm)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - start
    losses = [m["train/loss/total"] for _, m in logger.rows if "train/loss/total" in m]
    costs = {k: [m[cb.logging_prefix_full + "avg_transport_cost"] for _, m in logger.rows
                 if cb.logging_prefix_full + "avg_transport_cost" in m]
             for k, cb in cbs.items()}
    restored = {k: cb.compute_test_metrics().get(cb.logging_prefix_full + "psnr")
                for k, cb in cbs.items()}
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    psnr = test.get("test/metrics/psnr")
    print(f"mnist32 transport, weights from seed {seed}: {len(losses)} steps, loss (mean of "
          f"10) {first:.4f} -> {last:.4f}; transport costs {costs}; Sinkhorn launches per "
          f"validation {probe.per_epoch}; test PSNR {psnr:.3f} dB, restored (blur -> "
          f"transport) PSNR " + ", ".join(f"{k} {v:.3f} dB" for k, v in restored.items())
          + f"; fit {fit_s:.1f} s, fit + test {run_s:.1f} s", flush=True)
    check(len(losses) == MNIST_TRANSPORT_EPOCHS * dm.steps_per_epoch("train")
          and all(math.isfinite(v) for v in losses) and last < first,
          f"mnist32 transport: loss did not fall ({first} -> {last})")
    check(all(len(c) == MNIST_TRANSPORT_EPOCHS and all(math.isfinite(v) for v in c)
              for c in costs.values()), f"mnist32 transport: transport costs {costs}")
    check(probe.per_epoch == [1] * MNIST_TRANSPORT_EPOCHS,
          f"mnist32 transport: Sinkhorn launches per validation {probe.per_epoch}")
    check(psnr is not None and math.isfinite(psnr)
          and all(v is not None and math.isfinite(v) for v in restored.values()),
          f"mnist32 transport: test {test}, restored {restored}")
    # each validation's collage: 6 rows of 4 images of 32 x 32 x 1
    for cb in cbs.values():
        _check_collages("mnist32 transport", logger, cb, MNIST_TRANSPORT_EPOCHS,
                        (6 * 32, 4 * 32, 1))
    return model, cbs, restored


def phase_mnist32_transport(attention, sinkhorn, seed: int, workdir: Path):
    """The JAX latent-transport gate whole: five runs (weights from
    ``seed`` to ``seed + 4``) of the fit with the three callbacks
    and the test, their median restored PSNR against the gate's floor; then,
    on the first run's model, save/load, restore serving, and the Sinkhorn
    kernel's plan against the plain version's."""
    from ot_vae_tpu_torch.data import MNIST32
    from ot_vae_tpu_torch.serving import InferenceEngine

    dm = MNIST32(train_batch_size=50, val_batch_size=50, test_batch_size=50, seed=42,
                 synthetic_train=2500, synthetic_test=2200, test_val_split=0.9)
    start = time.perf_counter()
    dm.setup()
    print(f"mnist32 transport: synthetic data {time.perf_counter() - start:.1f} s", flush=True)
    attention.launch_count = attention.backward_launch_count = sinkhorn.launch_count = 0
    runs = [_mnist32_gate_run(dm, seed + i, sinkhorn) for i in range(MNIST_TRANSPORT_RUNS)]
    model, cbs, _ = runs[0]
    medians = {k: statistics.median(r[2][k] for r in runs) for k in cbs}
    print("mnist32 transport: median restored PSNR over the runs " + ", ".join(
        f"{k} {v:.3f} dB" for k, v in medians.items()), flush=True)
    check(medians["gaussian"] > MNIST_TRANSPORT_PSNR and medians["gmm"] > MNIST_TRANSPORT_PSNR,
          f"mnist32 transport: median restored PSNR {medians}, the gate's floor is "
          f"{MNIST_TRANSPORT_PSNR} dB for the Gaussian and GMM operators")

    # save, load into fresh callbacks and serve through restore: the path
    # ends here, so its launches are read before the checks below run
    workdir.mkdir(parents=True, exist_ok=True)
    loaded = mnist32_transports(model)
    for k, cb in cbs.items():
        cb.save_state(workdir / f"{k}_operator.npz")
        loaded[k].load_state(workdir / f"{k}_operator.npz")
    images = next(iter(dm.predict_batches()))[0][:64]  # raw 28 x 28 test images
    engine = InferenceEngine(model, batch_sizes=(64,))
    restores = {k: engine.restore(images, loaded[k],
                                  torch.Generator(device="cuda").manual_seed(11))
                for k in ("gaussian", "discrete")}
    torch.cuda.synchronize()
    launches = (attention.launch_count, attention.backward_launch_count,
                sinkhorn.launch_count)
    print(f"mnist32 transport launches (forward, backward, sinkhorn): {MNIST_TRANSPORT_RUNS} "
          f"fits and tests and 2 restores {launches}", flush=True)

    # the loaded operators transport bit for bit as the fitted ones
    x = model.inference_preprocess(torch.as_tensor(images, device="cuda"))
    z = model.eval_encode(x)
    moved = {k: [t.transport(z, torch.Generator(device="cuda").manual_seed(5))
                 for t in (cb, loaded[k])] for k, cb in cbs.items()}
    same = {k: bool(torch.equal(*m)) for k, m in moved.items()}
    # restore against the test-time path: encode, transport, decode
    errs = {}
    for k, got in restores.items():
        g = torch.Generator(device="cuda").manual_seed(11)
        with torch.inference_mode():
            want = model.inference_postprocess(model.eval_decode(cbs[k].transport(
                model.eval_encode(x, g), g))).cpu().numpy()
        errs[k] = (float(np.abs(got - want).max()), 1e-4 * max(1.0, float(np.abs(want).max())))
        check(got.shape == images.shape and bool(np.isfinite(got).all())
              and errs[k][0] <= errs[k][1], f"mnist32 transport: {k} restore {got.shape} "
              f"vs path, error {errs[k][0]}")
    print(f"mnist32 transport: save/load transports bit for bit: {same}; restore of "
          f"{len(images)} test images vs encode -> transport -> decode, max_abs_err: "
          + ", ".join(f"{k} {e:.3e} (tol {t:.1e})" for k, (e, t) in errs.items()), flush=True)
    check(all(same.values()), f"mnist32 transport: loaded operators transport differently {same}")

    # the fitted discrete operator's plan (the kernel's) against the plain
    # version's on the same fitted codebooks, at the path's reg: total cost,
    # then the test latents transported and restored through each plan
    cb = cbs["discrete"]
    op, st = cb.operator, cb.state
    m = op.source_model
    cost = 1.0 / (m.energy(st.target.codebook, st.source.codebook) + 1e-8)
    plain = sinkhorn.sinkhorn_log_kernel_reference(
        m.weights(st.source), m.weights(st.target), cost, reg=op.sinkhorn_reg,
        max_iter=op.sinkhorn_max_iter, threshold=op.sinkhorn_threshold)
    totals = [float((cost * plan).sum()) for plan in (st.plan, plain)]
    cost_err = abs(totals[0] - totals[1]) / abs(totals[1])
    loaded["discrete"].state = loaded["discrete"].state.replace(plan=plain)
    moved_plain = loaded["discrete"].transport(z, torch.Generator(device="cuda").manual_seed(5))
    moved_kernel = moved["discrete"][0]
    with torch.inference_mode():
        restored_images = [model.eval_decode(t) for t in (moved_kernel, moved_plain)]
    lat_err = ((moved_kernel - moved_plain).abs().max()
               / max(1.0, moved_plain.abs().max().item())).item()
    img_err = ((restored_images[0] - restored_images[1]).abs().max()
               / max(1.0, restored_images[1].abs().max().item())).item()
    print(f"mnist32 transport: fitted plan, kernel vs plain version: total cost "
          f"{totals[0]:.6g} vs {totals[1]:.6g}, rel err {cost_err:.3e} (tol "
          f"{SINKHORN_COST_RTOL:.0e}); largest entry difference "
          f"{(st.plan - plain).abs().max().item():.3e} of {plain.abs().max().item():.3e} "
          f"(not gated); transported latents max_abs_err over max(1, max|latent|) "
          f"{lat_err:.3e} (tol {TRANSPORT_TOL:.0e}), restored images {img_err:.3e} (tol "
          f"{TRANSPORT_TOL:.0e})", flush=True)
    check(cost_err <= SINKHORN_COST_RTOL, f"mnist32 transport: fitted plan cost {totals}")
    check(lat_err <= TRANSPORT_TOL and img_err <= TRANSPORT_TOL,
          f"mnist32 transport: kernel vs plain plan, latents {lat_err}, images {img_err}")
    return launches


def phase_mnist32_vae(attention, seed: int):
    """The MNIST32 VAE of configs/vae/defaults.yaml: 10 epochs of 24 steps
    at batch 250 with clipped gradients, then Trainer.test."""
    from ot_vae_tpu_torch.data import MNIST32
    from ot_vae_tpu_torch.metrics import PSNR, MetricCollection
    from ot_vae_tpu_torch.models import VAE
    from ot_vae_tpu_torch.networks import CNN
    from ot_vae_tpu_torch.priors import GaussianPrior
    from ot_vae_tpu_torch.trainer import Trainer

    torch.manual_seed(seed)
    model = VAE(CNN(1, 256, 32, 1, capacity=8, down_sample=True, residual="add"),
                CNN(128, 1, 1, 32, capacity=8, up_sample=True, residual="add"),
                GaussianPrior(loss_coeff=0.1), metrics=MetricCollection({"psnr": PSNR()}),
                gradient_clip_val=MNIST_VAE_CLIP)
    dm = MNIST32(train_batch_size=250, val_batch_size=250, test_batch_size=250, seed=42)
    logger = _Recorder()
    trainer = Trainer(max_epochs=MNIST_VAE_EPOCHS, seed=42, logger=logger,
                      log_every_n_steps=1)
    attention.launch_count = attention.backward_launch_count = 0
    start = time.perf_counter()
    trainer.fit(model, dm)
    test = trainer.test(model, dm)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - start
    losses = [m["train/loss/total"] for _, m in logger.rows if "train/loss/total" in m]
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    psnr = test.get("test/metrics/psnr", float("nan"))
    print(f"mnist32 vae: {len(losses)} steps at batch 250, clip {MNIST_VAE_CLIP:g}, loss "
          f"(mean of 10) {first:.4f} -> "
          f"{last:.4f}, val PSNR {trainer.logged_metrics.get('val/metrics/psnr'):.3f} dB, "
          f"test PSNR {psnr:.3f} dB; {run_s:.1f} s", flush=True)
    check(len(losses) == MNIST_VAE_EPOCHS * dm.steps_per_epoch("train")
          and all(math.isfinite(v) for v in losses) and last < first,
          f"mnist32 vae: loss did not fall ({first} -> {last})")
    check(math.isfinite(psnr), f"mnist32 vae: test PSNR {psnr}")
    return attention.launch_count, attention.backward_launch_count


def _bthd_inputs(gen, b, tq, tk, h, d, mult, dtype):
    q = torch.randn((b, tq, h * d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, tk, h * d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, tk, h * d), generator=gen, device="cuda").to(dtype)
    m = None
    if mult:
        keep = torch.rand((tq, tk), generator=gen, device="cuda") < BTHD_KEEP
        m = (keep.float() / BTHD_KEEP).to(dtype)
    return q, k, v, m


def _bhtc(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B, T, H·d] → a contiguous [B, H, T, d] copy."""
    b, t, width = x.shape
    return x.view(b, t, h, width // h).transpose(1, 2).contiguous()


def _gate(name, dtype, got, ref, lse, ref_lse):
    """Check one kernel output against its plain version; return the max abs
    error of out."""
    err = (got.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    rel = max_rel_err(got, ref, 1)
    if dtype == torch.bfloat16:
        gate, ok = f"max_rel_err={rel:.3e} (tol {BF16_REL_TOL:.1e})", rel <= BF16_REL_TOL
    else:
        gate, ok = f"(tol {OUT_TOL:.1e})", err <= OUT_TOL
    print(f"{name}: out max_abs_err={err:.3e} {gate} lse max_abs_err={lse_err:.3e} "
          f"(tol {LSE_TOL:.1e})", flush=True)
    check(math.isfinite(err) and ok, f"{name}: abs {err}, rel {rel}")
    check(math.isfinite(lse_err) and lse_err <= LSE_TOL, f"{name}: lse {lse_err}")
    return err


def _with_shares(row: dict) -> dict:
    """``row`` with its share of the bound (bound_ms / ms) and its factor
    against the library call (ms / library_ms, None without one)."""
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["library_factor"] = (None if row.get("library_ms") is None
                             else row["ms"] / row["library_ms"])
    return row


def phase_bthd(attention):
    """Rows 7 and 3 against their plain versions; their times at the FFHQ128
    ViT's shapes; the fused_attention entry's launches at the ViTs' shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1357)
    worst = {"bthd": 0.0, "bhtc": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        shapes = BTHD_SHAPES + (BTHD_TILE_SHAPES if dtype == torch.bfloat16 else [])
        for b, tq, tk, h, d, causal, mult in shapes:
            q, k, v, m = _bthd_inputs(gen, b, tq, tk, h, d, mult, dtype)
            scale = 1.0 / math.sqrt(d)
            out, lse = attention.attention_bthd(q, k, v, h, scale, causal, m)
            torch.cuda.synchronize()
            ref, ref_lse = attention.attention_bthd_reference(q, k, v, h, scale, causal, m)
            shape = (f"B={b} Tq={tq} Tk={tk} H={h} d={d}" + (" causal" if causal else "")
                     + (" mult" if mult else ""))
            err = _gate(f"bthd check {name} {shape}", dtype, out, ref, lse, ref_lse)
            if dtype == torch.bfloat16:
                worst["bthd"] = max(worst["bthd"], err)
            if tq == tk and not (causal or mult):
                qb, kb, vb = (_bhtc(x, h) for x in (q, k, v))
                out, lse = attention.attention_bhtc(qb, kb, vb, scale)
                torch.cuda.synchronize()
                ref, ref_lse = attention.attention_bhtc_reference(qb, kb, vb, scale)
                err = _gate(f"bhtc check {name} B={b} H={h} T={tq} d={d}", dtype, out, ref,
                            lse, ref_lse)
                if dtype == torch.bfloat16:
                    worst["bhtc"] = max(worst["bhtc"], err)
            del q, k, v, m, out, lse, ref, ref_lse

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timings = {}
    for h in (4, 2):  # the FFHQ128 ViT's encoder and decoder layers
        b, t, d, dtype = 64, 1024, 128, torch.bfloat16
        q, k, v, _ = _bthd_inputs(gen, b, t, t, h, d, False, dtype)
        qb, kb, vb = (_bhtc(x, h) for x in (q, k, v))
        scale = 1.0 / math.sqrt(d)
        # q, k, v read once, out written once (2 bytes an entry), lse (f32)
        n_bytes = 4 * q.numel() * q.element_size() + b * h * t * 4
        flops = 4.0 * t * t * d * b * h
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
        bound = {"bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms > ops_ms else "operations"}
        library_ms = time_ms(lambda: sdpa(qb, kb, vb, scale=scale), flush=flush)
        timings[("bthd", h)] = {
            "ms": time_ms(lambda: attention.attention_bthd(q, k, v, h, scale), flush=flush),
            "plain_ms": time_ms(lambda: attention.attention_bthd_reference(
                q, k, v, h, scale), flush=flush, reps=10),
            "library_ms": library_ms, **bound}
        timings[("bhtc", h)] = {
            "ms": time_ms(lambda: attention.attention_bhtc(qb, kb, vb, scale), flush=flush),
            "plain_ms": time_ms(lambda: attention.attention_bhtc_reference(
                qb, kb, vb, scale), flush=flush, reps=10),
            "library_ms": library_ms, **bound}
        for kind in ("bthd", "bhtc"):
            row = _with_shares(timings[(kind, h)])
            print(f"{kind} time bf16 B={b} T={t} H={h} d={d}: kernel {row['ms']:.4f} ms, "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; {flops:.3e} FLOP, "
                  f"{n_bytes / 1e6:.1f} MB; share {row['bound_share']:.4f}), plain "
                  f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms (kernel "
                  f"{row['library_factor']:.2f}x); {flops / row['ms'] / 1e9:.1f} TFLOP/s",
                  flush=True)
        del q, k, v, qb, kb, vb
    del flush

    # the fused_attention entry (row 3) at the ViTs' self-attention shapes,
    # as a caller holding [B, H, T, d] tensors would reach it
    attention.bhtc_launch_count = 0
    for b, tq, tk, h, d, causal, mult in BTHD_SHAPES[:4]:
        x = torch.randn((b, h, tq, d), generator=gen, device="cuda").to(torch.bfloat16)
        out = attention.fused_attention(x, x, x)
        torch.cuda.synchronize()
        check(out.shape == x.shape and bool(torch.isfinite(out).all()),
              f"fused_attention B={b} H={h} T={tq} d={d}")
    entry_launches = attention.bhtc_launch_count
    check(entry_launches == 4, f"fused_attention launched row 3 {entry_launches} times, "
                               f"expected 4")
    print(f"fused_attention entry at the ViTs' 4 shapes: row 3 launches {entry_launches}",
          flush=True)
    return worst, timings, entry_launches


def _serve_rates(calls, n):
    rates = {}
    for kind, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        reps = 5
        start = time.perf_counter()
        for _ in range(reps):
            fn()  # returns host numpy: each call ends synchronised
        rates[kind] = n * reps / (time.perf_counter() - start)
    return rates


def _serve_checked(attention, engine, requests, expected):
    """Run (kind, fn, shape) requests with the row-7 count set to 0 before
    and read after each; return the outputs and the total launches."""
    attention.bthd_launch_count = 0
    packed = attention.launch_count
    seen, outs = 0, []
    for kind, fn, shape in requests:
        out = fn()
        torch.cuda.synchronize()
        launched = attention.bthd_launch_count - seen
        seen = attention.bthd_launch_count
        check(out.shape == shape, f"{kind}: shape {out.shape} != {shape}")
        check(bool(np.isfinite(out).all()), f"{kind}: non-finite output")
        check(launched == expected[kind],
              f"{kind}: BTHD kernel launched {launched} times, expected {expected[kind]}")
        outs.append(out)
    check(attention.launch_count == packed, "the ViT path launched the packed kernel")
    total = sum(expected[kind] for kind, _, _ in requests)
    check(attention.bthd_launch_count == total,
          f"row 7 launched {attention.bthd_launch_count} times, expected {total}")
    return outs, attention.bthd_launch_count


def cifar_vit_vae(seed: int, dtype=torch.float32):
    """The conditional CIFAR10 ViT VAE of configs/vae/vit.yaml (dropout 0.1,
    PSNR metric, Adam at the model's default 1e-3), weights from ``seed``."""
    from ot_vae_tpu_torch.data import cifar10_transforms
    from ot_vae_tpu_torch.metrics import PSNR, MetricCollection
    from ot_vae_tpu_torch.models import VAE
    from ot_vae_tpu_torch.networks.vit import ViT
    from ot_vae_tpu_torch.priors import ConditionalGaussianPrior

    torch.manual_seed(seed)
    model = VAE(ViT(**CIFAR_VIT_ENCODER, dtype=dtype), ViT(**CIFAR_VIT_DECODER, dtype=dtype),
                ConditionalGaussianPrior(**CIFAR_VIT_PRIOR),
                metrics=MetricCollection({"psnr": PSNR()}), conditional=True)
    model.inference_preprocess, model.inference_postprocess = cifar10_transforms()
    return model


def ffhq_vit_vae(seed: int, dtype=torch.bfloat16, depth: int = 8):
    """The FFHQ128 ViT VAE of configs/vae/vit_ffhq128.yaml (PSNR metric, Adam
    at the model's default 1e-3), weights from ``seed`` (f32 parameters,
    ``dtype`` activations); ``depth`` cuts both ViTs' depth."""
    from ot_vae_tpu_torch.data import ffhq128_transforms
    from ot_vae_tpu_torch.metrics import PSNR, MetricCollection
    from ot_vae_tpu_torch.models import VAE
    from ot_vae_tpu_torch.networks.vit import ViT
    from ot_vae_tpu_torch.priors import GaussianPrior

    torch.manual_seed(seed)
    model = VAE(ViT(**{**FFHQ_VIT_ENCODER, "depth": depth}, dtype=dtype),
                ViT(**{**FFHQ_VIT_DECODER, "depth": depth}, dtype=dtype),
                GaussianPrior(loss_coeff=0.1, reparam_dim=-1),
                metrics=MetricCollection({"psnr": PSNR()}))
    model.inference_preprocess, model.inference_postprocess = ffhq128_transforms()
    return model


def phase_serve_cifar_vit(attention, seed: int):
    """The conditional CIFAR10 ViT VAE through the engine with labels."""
    from ot_vae_tpu_torch.data import CIFAR10
    from ot_vae_tpu_torch.serving import InferenceEngine

    dm = CIFAR10(seed=42)
    dm.setup()
    images, labels = dm.test_dataset.images, dm.test_dataset.labels
    engine = InferenceEngine(cifar_vit_vae(seed), batch_sizes=(1, 8, 64))
    latent = engine.model.latent_size
    rng = np.random.default_rng(seed + 2)
    eps = rng.standard_normal((8, *latent)).astype(np.float32)
    expected = {"reconstruct": 6, "encode": 3, "decode": 3, "sample": 3}
    z = engine.encode(images[:8], labels=labels[:8])
    requests = [("reconstruct", lambda n=n: engine.reconstruct(images[:n], labels=labels[:n]),
                 (n, 32, 32, 3)) for n in (1, 5, 64)]
    requests += [
        ("encode", lambda: engine.encode(images[:8], labels=labels[:8]), (8, *latent)),
        ("decode", lambda: engine.decode(z, labels=labels[:8]), (8, 32, 32, 3)),
        ("sample", lambda: engine.sample(8, labels=labels[:8]), (8, 32, 32, 3))]
    _, launches = _serve_checked(attention, engine, requests, expected)

    # a request of 5 is padded into bucket 8: its rows against the same rows
    # of a full request of 8 with other images after them, the same ε
    padded = engine.reconstruct(images[:5], noise=eps[:5], labels=labels[:5])
    full = engine.reconstruct(np.concatenate([images[:5], images[100:103]]), noise=eps,
                              labels=np.concatenate([labels[:5], labels[100:103]]))
    pad_err = float(np.abs(padded - full[:5]).max()) / max(1.0, float(np.abs(full).max()))
    check(pad_err <= PAD_TOL, f"CIFAR10 ViT: padded rows moved by {pad_err}")
    print(f"serve CIFAR10 ViT f32 full width: reconstruct 1/5/64, encode 8, decode 8, "
          f"sample 8 ok with labels; row-7 launches {launches}; padded request vs full "
          f"bucket max_abs_err over max(1, range) {pad_err:.3e} (tol {PAD_TOL:.0e})",
          flush=True)

    z64 = engine.encode(images[:64], labels=labels[:64])
    rates = _serve_rates({
        "reconstruct": lambda: engine.reconstruct(images[:64], labels=labels[:64]),
        "encode": lambda: engine.encode(images[:64], labels=labels[:64]),
        "decode": lambda: engine.decode(z64, labels=labels[:64]),
        "sample": lambda: engine.sample(64, labels=labels[:64])}, 64)
    print("serve CIFAR10 ViT img/s at bucket 64 (f32): " + ", ".join(
        f"{k} {v:.1f}" for k, v in rates.items()), flush=True)
    return launches, engine


def phase_serve_ffhq_vit(attention, seed: int):
    """The FFHQ128 ViT VAE at bucket 64, bf16 activations."""
    from ot_vae_tpu_torch.data import FFHQ128
    from ot_vae_tpu_torch.serving import InferenceEngine

    dm = FFHQ128(synthetic_train=64, synthetic_test=128, seed=42)
    dm.setup()
    images = dm.predict_dataset.images[:64]
    engine = InferenceEngine(ffhq_vit_vae(seed), batch_sizes=(1, 8, 64))
    latent = engine.model.latent_size
    expected = {"reconstruct": 16, "encode": 8, "decode": 8, "sample": 8}
    z = engine.encode(images)
    requests = [("reconstruct", lambda: engine.reconstruct(images), (64, 128, 128, 3)),
                ("encode", lambda: engine.encode(images), (64, *latent)),
                ("decode", lambda: engine.decode(z), (64, 128, 128, 3)),
                ("sample", lambda: engine.sample(64), (64, 128, 128, 3))]
    _, launches = _serve_checked(attention, engine, requests, expected)
    print(f"serve FFHQ128 ViT bf16 full width: reconstruct, encode, decode, sample at 64 "
          f"ok; row-7 launches {launches}", flush=True)
    rates = _serve_rates({"reconstruct": lambda: engine.reconstruct(images),
                          "encode": lambda: engine.encode(images),
                          "decode": lambda: engine.decode(z),
                          "sample": lambda: engine.sample(64)}, 64)
    print("serve FFHQ128 ViT img/s at bucket 64 (bf16): " + ", ".join(
        f"{k} {v:.1f}" for k, v in rates.items()), flush=True)
    return launches, engine


def phase_vit_whole_path(cifar_engine, ffhq_engine, seed: int):
    """Both ViT VAEs in f32 on the card (the kernel, TF32 off) against the
    port on the CPU (the plain version), with the same ε and labels."""
    from ot_vae_tpu_torch.serving import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed + 3)
    # (name, engine, builder, images, size, kwargs, the served dtype)
    cases = [("CIFAR10 ViT", cifar_engine, cifar_vit_vae, 4, 32, {"labels": np.array(
        [0, 3, 7, 9], np.int32)}, torch.float32),
             ("FFHQ128 ViT", ffhq_engine, ffhq_vit_vae, 2, 128, {}, torch.bfloat16)]
    for name, engine, build, n, size, kwargs, served in cases:
        state = {k: v.cpu() for k, v in engine.model.state_dict().items()}
        images = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
        noise = rng.standard_normal((n, *engine.model.latent_size)).astype(np.float32)

        def reconstruct(device, dtype):
            model = build(seed, dtype)
            model.load_state_dict(state, strict=True)
            return InferenceEngine(model, batch_sizes=(n,), device=device).reconstruct(
                images, noise=noise, **kwargs)

        ref = reconstruct("cpu", torch.float32)
        out = reconstruct("cuda", torch.float32)
        err = float(np.abs(out - ref).max())
        tol = VIT_PATH_TOL * max(1.0, float(np.abs(ref).max()))
        print(f"whole path {name} f32 card vs CPU, reconstruct {n}: max_abs_err={err:.3e} "
              f"(tol {tol:.3e}, output range {np.abs(ref).max():.3f})", flush=True)
        check(bool(np.isfinite(out).all()) and err <= tol,
              f"whole path {name}: card vs CPU {err} > {tol}")
        if served == torch.float32:
            continue
        # the served dtype: bf16 on the card against bf16 on the CPU
        ref16, out16 = reconstruct("cpu", served), reconstruct("cuda", served)
        err = float(np.abs(out16 - ref16).max())
        rms = float(np.sqrt(np.mean(np.square(out16 - ref16))))
        scale = max(1.0, float(np.abs(ref16).max()))
        tol, rms_tol = VIT_BF16_PATH_TOL * scale, VIT_BF16_PATH_RMS_TOL * scale
        print(f"whole path {name} bf16 card vs CPU, reconstruct {n}: max_abs_err={err:.3e} "
              f"(tol {tol:.3e}, output range {np.abs(ref16).max():.3f}), rms {rms:.3e} "
              f"(tol {rms_tol:.3e}); bf16 card vs f32 CPU (not checked): max_abs_err="
              f"{float(np.abs(out16 - ref).max()):.3e}", flush=True)
        check(bool(np.isfinite(out16).all()) and err <= tol and rms <= rms_tol,
              f"whole path {name} bf16: card vs CPU {err} > {tol} or rms {rms} > {rms_tol}")


def _gate_backward(name, dtype, grads, refs):
    """Check (dq, dk, dv) against the plain version's; return the largest
    max abs error."""
    errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(grads, refs)]
    rels = [max_rel_err(g, r, 1, SMALL_FLOOR) for g, r in zip(grads, refs)]
    if dtype == torch.bfloat16:
        gate, ok = (f"max_rel_err dq {rels[0]:.3e} dk {rels[1]:.3e} dv {rels[2]:.3e} "
                    f"(tol {BF16_REL_TOL:.1e})", max(rels) <= BF16_REL_TOL)
    else:
        tols = [BWD_TOL * max(1.0, r.float().abs().max().item()) for r in refs]
        gate = f"(tol {max(tols):.3e})"
        ok = all(e <= t for e, t in zip(errs, tols))
    print(f"{name}: max_abs_err dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} {gate}",
          flush=True)
    check(all(math.isfinite(e) for e in errs) and ok, f"{name}: abs {errs}, rel {rels}")
    return max(errs)


def phase_bthd_backward(attention):
    """Rows 8 and 4 against their plain versions; their times at the FFHQ128
    ViT's train shapes; the fused_attention entry's backward launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2579)
    worst = {"bthd": 0.0, "bhtc": 0.0}
    repeats = 0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        shapes = BWD_BTHD_SHAPES + (BTHD_TILE_SHAPES if dtype == torch.bfloat16 else [])
        for b, tq, tk, h, d, causal, mult in shapes:
            q, k, v, m = _bthd_inputs(gen, b, tq, tk, h, d, mult, dtype)
            dout = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            scale = 1.0 / math.sqrt(d)
            out, lse = attention.attention_bthd(q, k, v, h, scale, causal, m)
            grads = attention.attention_bthd_backward(q, k, v, out, lse, dout, h, scale,
                                                      causal, m)
            torch.cuda.synchronize()
            refs = attention.attention_bthd_backward_reference(q, k, v, out, lse, dout, h,
                                                               scale, causal, m)
            shape = (f"B={b} Tq={tq} Tk={tk} H={h} d={d}" + (" causal" if causal else "")
                     + (" mult" if mult else ""))
            err = _gate_backward(f"bthd backward check {name} {shape}", dtype, grads, refs)
            if dtype == torch.bfloat16:
                worst["bthd"] = max(worst["bthd"], err)
                again = attention.attention_bthd_backward(q, k, v, out, lse, dout, h, scale,
                                                          causal, m)
                check(all(torch.equal(g, a) for g, a in zip(grads, again)),
                      f"bthd backward {shape}: a second run differs")
                repeats += 1
            if tq == tk and not (causal or mult):
                qb, kb, vb, ob, db = (_bhtc(x, h) for x in (q, k, v, out, dout))
                ob, lse_b = attention.attention_bhtc(qb, kb, vb, scale)
                grads = attention.attention_bhtc_backward(qb, kb, vb, ob, lse_b, db, scale)
                torch.cuda.synchronize()
                refs = attention.attention_bhtc_backward_reference(qb, kb, vb, ob, lse_b, db,
                                                                   scale)
                err = _gate_backward(f"bhtc backward check {name} B={b} H={h} T={tq} d={d}",
                                     dtype, grads, refs)
                if dtype == torch.bfloat16:
                    worst["bhtc"] = max(worst["bhtc"], err)
                    again = attention.attention_bhtc_backward(qb, kb, vb, ob, lse_b, db, scale)
                    check(all(torch.equal(g, a) for g, a in zip(grads, again)),
                          f"bhtc backward B={b} H={h} T={tq} d={d}: a second run differs")
                    repeats += 1
                del qb, kb, vb, ob, db, lse_b
            del q, k, v, m, dout, out, lse, grads, refs
    print(f"bthd/bhtc backward bf16: {repeats} checks repeated bit for bit", flush=True)

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timings = {}
    for h in (4, 2):  # the FFHQ128 ViT's encoder and decoder layers
        b, t, d, dtype = VIT_TRAIN_BATCH, 1024, 128, torch.bfloat16
        q, k, v, _ = _bthd_inputs(gen, b, t, t, h, d, False, dtype)
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        scale = 1.0 / math.sqrt(d)
        out, lse = attention.attention_bthd(q, k, v, h, scale)
        qb, kb, vb, ob, db = (_bhtc(x, h) for x in (q, k, v, out, dout))
        lse_b = lse.view(b * h, t)
        # q, k, v, out and dout read once, dq, dk and dv written once (2 bytes
        # an entry), lse read (f32); S, dP, dV, dQ and dK are 2·T²·d FLOP
        # each per (batch, head)
        n_bytes = 8 * q.numel() * q.element_size() + lse.numel() * 4
        flops = 10.0 * t * t * d * b * h
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
        bound = {"bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms > ops_ms else "operations"}
        # SDPA (a yardstick only) on the [B, H, T, d] copies: its backward
        # from one retained forward graph, and forward + backward
        sq, sk, sv = (x.detach().requires_grad_() for x in (qb, kb, vb))
        sdpa_out = sdpa(sq, sk, sv, scale=scale)
        library_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (sq, sk, sv), db,
                                                         retain_graph=True), flush)
        sdpa_fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(
            sdpa(sq, sk, sv, scale=scale), (sq, sk, sv), db), flush)
        xq, xk, xv = (x.detach().requires_grad_() for x in (q, k, v))
        timings[("bthd", h)] = {
            "ms": time_ms(lambda: attention.attention_bthd_backward(
                q, k, v, out, lse, dout, h, scale), flush, reps=10),
            "plain_ms": time_ms(lambda: attention.attention_bthd_backward_reference(
                q, k, v, out, lse, dout, h, scale), flush, reps=5),
            "library_ms": library_ms,
            "fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
                attention.fused_attention_bthd(xq, xk, xv, h, scale), (xq, xk, xv), dout),
                flush, reps=10),
            "sdpa_fwd_bwd_ms": sdpa_fwd_bwd_ms, **bound}
        timings[("bhtc", h)] = {
            "ms": time_ms(lambda: attention.attention_bhtc_backward(
                qb, kb, vb, ob, lse_b, db, scale), flush, reps=10),
            "plain_ms": time_ms(lambda: attention.attention_bhtc_backward_reference(
                qb, kb, vb, ob, lse_b, db, scale), flush, reps=5),
            "library_ms": library_ms, **bound}
        for kind in ("bthd", "bhtc"):
            row = _with_shares(timings[(kind, h)])
            both = (f"; fwd+bwd: port {row['fwd_bwd_ms']:.4f} ms, sdpa "
                    f"{row['sdpa_fwd_bwd_ms']:.4f} ms" if kind == "bthd" else "")
            print(f"{kind} backward time bf16 B={b} T={t} H={h} d={d}: kernel "
                  f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
                  f"{flops:.3e} FLOP, {n_bytes / 1e6:.1f} MB; share "
                  f"{row['bound_share']:.4f}), plain {row['plain_ms']:.4f} ms, sdpa backward "
                  f"{row['library_ms']:.4f} ms (kernel {row['library_factor']:.2f}x){both}; "
                  f"{flops / row['ms'] / 1e9:.1f} TFLOP/s", flush=True)
        del q, k, v, dout, out, lse, qb, kb, vb, ob, db, lse_b, sq, sk, sv, sdpa_out, xq, xk, xv
    del flush

    # the fused_attention entry's backward (row 4) at the ViTs' train shapes,
    # as a caller holding [B, H, T, d] tensors would reach it
    attention.bhtc_bwd_launch_count = 0
    for b, tq, tk, h, d, causal, mult in BWD_BTHD_SHAPES[:4]:
        x = torch.randn((b, h, tq, d), generator=gen, device="cuda").to(
            torch.bfloat16).requires_grad_()
        attention.fused_attention(x, x, x).sum().backward()
        torch.cuda.synchronize()
        check(x.grad.shape == x.shape and bool(torch.isfinite(x.grad).all()),
              f"fused_attention backward B={b} H={h} T={tq} d={d}")
    entry_launches = attention.bhtc_bwd_launch_count
    check(entry_launches == 4, f"fused_attention's backward launched row 4 "
                               f"{entry_launches} times, expected 4")
    print(f"fused_attention entry backward at the ViTs' 4 train shapes: row 4 launches "
          f"{entry_launches}", flush=True)
    return worst, timings, entry_launches


class DrawTape:
    """Within ``with``: the first run's random draws through the port's draw
    functions (dropout keep masks, Gumbel noise, sampled codebook indices),
    made on the CPU from that run's generators and recorded in call order,
    are handed to the later runs (after ``rewind()``) on their own device, so
    that every run draws the same numbers."""

    def __init__(self):
        from ot_vae_tpu_torch.distributions import codebook
        from ot_vae_tpu_torch.networks import nets_utils

        # name: (module, draw, the call's device, the shape it asks for)
        self.sites = {
            "dropout_keep": (nets_utils, nets_utils.dropout_keep, lambda a: a[3],
                             lambda a: tuple(a[0])),
            "gumbel_noise": (codebook, codebook.gumbel_noise, lambda a: a[2],
                             lambda a: tuple(a[0])),
            "_categorical": (codebook, codebook._categorical, lambda a: a[0].device,
                             lambda a: tuple(a[0].shape[:-1]) + ((a[2],) if len(a) > 2
                                                                 and a[2] else ())),
        }
        self.draws = {name: [] for name in self.sites}
        self.at = dict.fromkeys(self.sites, 0)

    def _replay(self, name):
        _, draw, device_of, shape_of = self.sites[name]

        def replay(*args):
            records, at = self.draws[name], self.at[name]
            if at == len(records):
                check(torch.device(device_of(args)).type == "cpu",
                      f"draw tape: {name} first drawn off the CPU")
                records.append(draw(*args))
            self.at[name] = at + 1
            out = records[at]
            check(tuple(out.shape) == shape_of(args),
                  f"draw tape: {name} {tuple(out.shape)} replayed for {shape_of(args)}")
            return out.to(device_of(args))
        return replay

    def rewind(self):
        self.at = dict.fromkeys(self.sites, 0)

    def __enter__(self):
        for name, (module, _, _, _) in self.sites.items():
            setattr(module, name, self._replay(name))
        return self

    def __exit__(self, *exc):
        for name, (module, draw, _, _) in self.sites.items():
            setattr(module, name, draw)


def phase_vit_train_card_vs_cpu(seed: int):
    """Two train steps at batch 4 from the same weights, images, labels, ε,
    dropout masks and flips: f32 on the CPU (which draws the masks), on the
    card and in f64 on the CPU, for the conditional CIFAR10 ViT VAE (full
    width, dropout 0.1) and the FFHQ128 ViT VAE (full width, depth 2)."""
    from ot_vae_tpu_torch.data import CIFAR10, ArrayDataset, BaseDatamodule
    from ot_vae_tpu_torch.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed + 5)
    dm = CIFAR10(synthetic_train=64, synthetic_test=10, train_batch_size=4, seed=seed)
    cifar_batches = list(dm.train_batches(0))[:2]  # normalised and flipped
    ffhq_images = [rng.uniform(0, 1, (4, 128, 128, 3)).astype(np.float32) for _ in range(2)]
    cases = [("CIFAR10 ViT", cifar_vit_vae, cifar_batches, (1, 128)),
             ("FFHQ128 ViT depth 2", lambda s, dtype: ffhq_vit_vae(s, dtype, depth=2),
              [(x, np.zeros(4, np.int32)) for x in ffhq_images], (1024, 256))]
    for name, build, batches, latent in cases:
        state = build(seed + 6, torch.float32).state_dict()
        noise = [rng.standard_normal((4, *latent)).astype(np.float32) for _ in batches]
        runs = {}
        with DrawTape() as tape:
            for run, device, dtype in (("cpu", "cpu", torch.float32),
                                       ("card", "cuda", torch.float32),
                                       ("cpu64", "cpu", torch.float64)):
                tape.rewind()
                model = build(seed + 6, dtype)
                model.load_state_dict(state, strict=True)
                model.to(dtype)
                trainer = Trainer(device=device, seed=seed)
                trainer.setup_fit(model, BaseDatamodule(
                    train_dataset=ArrayDataset(*batches[0])))
                losses, grads = [], None
                for i, (batch, eps) in enumerate(zip(batches, noise)):
                    logs, _ = trainer.train_step(model, batch, noise=eps,
                                                 dropout_rng=trainer.generator(4, 0, i))
                    losses.append(float(logs["train/loss/total"]))
                    if grads is None:
                        grads = {k: p.grad.detach().double().cpu()
                                 for k, p in model.net.named_parameters()}
                runs[run] = (losses, grads)
            n_masks = len(tape.draws["dropout_keep"])
        _check_train_runs(f"{name}: {n_masks} dropout masks handed across", runs)


def _fit(attention, model, dm, workdir: Path, seed: int, callbacks=(), max_epochs: int = 1,
         read=None, **trainer_kw):
    """Trainer.fit with ``callbacks``, a launch probe, a recorder and a
    checkpoint; every launch count set to 0 before the fit. The probe
    records ``read()``, a tuple of counters: by default the BTHD counters
    (row 7, row 8, launches with a multiplier, dout copies, causal
    launches), and then the fit must launch no packed-attention kernel."""
    from ot_vae_tpu_torch.trainer import Callback, ModelCheckpointCallback, Trainer

    def bthd():
        return (attention.bthd_launch_count, attention.bthd_bwd_launch_count,
                attention.mult_launch_count, attention.dout_copies,
                attention.causal_launch_count)

    counters = read or bthd

    class LaunchProbe(Callback):
        """Synchronises after each train step and records the host time and
        ``counters()``, at the start of each epoch and after each step."""

        def __init__(self):
            self.rows = []

        def _record(self, epoch_start: bool = False):
            torch.cuda.synchronize()
            self.rows.append((epoch_start, time.perf_counter(), *counters()))

        def on_train_epoch_start(self, trainer, model):
            self._record(epoch_start=True)

        def on_train_batch_end(self, trainer, model, outputs, batch, batch_idx):
            self._record()

        def steps(self):
            """Per-step differences of the counters; the validation between
            two epochs is no step's."""
            return [tuple(b - a for a, b in zip(r0[2:], r1[2:]))
                    for r0, r1 in zip(self.rows[:-1], self.rows[1:]) if not r1[0]]

        def img_s(self, batch: int, steady: int = 3) -> float:
            """Steady train img/s of the first epoch, from the end of step
            ``steady`` on."""
            times = [r[1] for r in self.rows[:next(
                (i for i, r in enumerate(self.rows) if i and r[0]), len(self.rows))]]
            return (len(times) - 1 - steady) * batch / (times[-1] - times[steady])

    probe, logger = LaunchProbe(), _Recorder()
    ckpt = ModelCheckpointCallback(dirpath=str(workdir))
    trainer = Trainer(max_epochs=max_epochs, log_every_n_steps=1,
                      callbacks=[*callbacks, probe, ckpt], logger=logger, seed=seed,
                      **trainer_kw)
    torch.cuda.reset_peak_memory_stats()
    attention.bthd_launch_count = attention.bthd_bwd_launch_count = 0
    attention.mult_launch_count = attention.dout_copies = attention.causal_launch_count = 0
    attention.launch_count = attention.backward_launch_count = 0
    trainer.fit(model, dm)
    torch.cuda.synchronize()
    check(read is not None or attention.launch_count == attention.backward_launch_count == 0,
          "the ViT path launched the packed-attention kernels")
    launches = {"forward": attention.bthd_launch_count,
                "backward": attention.bthd_bwd_launch_count,
                "mult": attention.mult_launch_count}
    losses = [m["train/loss/total"] for _, m in logger.rows if "train/loss/total" in m]
    psnr = trainer.logged_metrics.get("val/metrics/psnr", float("nan"))
    return trainer, probe, ckpt, losses, psnr, launches


def phase_train_cifar_vit(attention, seed: int, workdir: Path):
    """Trainer.fit of the conditional CIFAR10 ViT VAE at configs/vae/vit.yaml's
    recipe on the seeded CIFAR10 fallback; the checkpoint served with
    labels."""
    from ot_vae_tpu_torch.data import CIFAR10
    from ot_vae_tpu_torch.serving import InferenceEngine

    dm = CIFAR10(synthetic_train=CIFAR_TRAIN_IMAGES, train_batch_size=CIFAR_TRAIN_BATCH,
                 seed=seed)
    dm.setup()
    model = cifar_vit_vae(seed)
    model.learning_rate = CIFAR_TRAIN_LR
    trainer, probe, ckpt, losses, psnr, launches = _fit(attention, model, dm,
                                                        workdir / "cifar_vit", seed)
    n_steps = dm.steps_per_epoch("train")
    first, last = (statistics.mean(losses[:20]), statistics.mean(losses[-20:]))
    check(len(losses) == n_steps, f"CIFAR10 ViT fit: {len(losses)} losses logged")
    check(all(math.isfinite(v) for v in losses), "CIFAR10 ViT fit: non-finite loss")
    check(last < first, f"CIFAR10 ViT fit: loss did not fall ({first} -> {last})")
    check(math.isfinite(psnr), f"CIFAR10 ViT fit: validation PSNR {psnr}")
    steps = probe.steps()
    bad = [i for i, s in enumerate(steps) if s[:3] != (6, 6, 12)]
    check(len(steps) == n_steps and not bad,
          f"CIFAR10 ViT fit: steps {bad[:5]} launched (row 7, row 8, with mult) "
          f"{[steps[i][:3] for i in bad[:5]]}, expected (6, 6, 12)")
    # a validation batch: the encoder once (its latents come from the same
    # pass) and the decoder, 3 blocks each, no dropout
    val_batches = dm.steps_per_epoch("val")
    check(launches == {"forward": 6 * n_steps + 6 * val_batches, "backward": 6 * n_steps,
                       "mult": 12 * n_steps}, f"CIFAR10 ViT fit: launches {launches}")
    check(ckpt.best_path is not None, "CIFAR10 ViT fit: no checkpoint saved")
    img_s = probe.img_s(CIFAR_TRAIN_BATCH)
    print(f"train CIFAR10 ViT f32 full width, batch {CIFAR_TRAIN_BATCH}, dropout 0.1, flips, "
          f"lr {CIFAR_TRAIN_LR:g}: {n_steps} steps, loss (mean of 20) {first:.4f} -> "
          f"{last:.4f}, val PSNR {psnr:.3f} dB; launches per step 6 row 7 + 6 row 8, all "
          f"with the multiplier (run: {launches}, {val_batches} validation batches); steady "
          f"train img/s (synchronised) {img_s:.1f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    served = InferenceEngine(cifar_vit_vae(seed + 1), checkpoint_path=ckpt.best_path)
    trained = InferenceEngine(model)
    check(served.model.inference_preprocess == trained.model.inference_preprocess,
          "CIFAR10 ViT checkpoint: inference transforms differ")
    rng = np.random.default_rng(seed + 7)
    images = dm.test_dataset.images[:8]
    labels = dm.test_dataset.labels[:8]
    noise = rng.standard_normal((8, *model.latent_size)).astype(np.float32)
    got = served.reconstruct(images, noise=noise, labels=labels)
    want = trained.reconstruct(images, noise=noise, labels=labels)
    err = float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))
    print(f"serve CIFAR10 ViT checkpoint: reconstruct 8 with labels from "
          f"{Path(ckpt.best_path).name} vs the trained model: max_abs_err over max(1, range) "
          f"{err:.3e} (tol {CIFAR_CKPT_TOL:.0e})", flush=True)
    check(got.shape == (8, 32, 32, 3) and bool(np.isfinite(got).all())
          and err <= CIFAR_CKPT_TOL, f"CIFAR10 ViT checkpoint: served vs trained {err}")
    return launches


def phase_train_ffhq_vit(attention, seed: int, workdir: Path):
    """Trainer.fit of the FFHQ128 ViT VAE at full width and depth, bf16
    activations, batch 32, TRAIN_STEPS steps and one validation."""
    from ot_vae_tpu_torch.data import FFHQ128

    data = workdir / "ffhq128"
    dm = FFHQ128(root=(str(data / "train"), str(data / "test")),
                 synthetic_train=VIT_TRAIN_BATCH * TRAIN_STEPS, synthetic_test=72,
                 train_batch_size=VIT_TRAIN_BATCH, val_batch_size=VIT_TRAIN_BATCH, seed=seed)
    dm.setup()
    model = ffhq_vit_vae(seed)
    model.learning_rate = VIT_TRAIN_LR
    trainer, probe, ckpt, losses, psnr, launches = _fit(attention, model, dm,
                                                        workdir / "ffhq_vit", seed)
    check(len(losses) == TRAIN_STEPS, f"FFHQ128 ViT fit: {len(losses)} losses logged")
    check(all(math.isfinite(v) for v in losses), f"FFHQ128 ViT fit: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"FFHQ128 ViT fit: loss did not fall ({losses[0]} -> "
                                  f"{losses[-1]})")
    check(math.isfinite(psnr), f"FFHQ128 ViT fit: validation PSNR {psnr}")
    steps = probe.steps()
    bad = [i for i, s in enumerate(steps) if s[:3] != (16, 16, 0)]
    check(len(steps) == TRAIN_STEPS and not bad,
          f"FFHQ128 ViT fit: steps {bad[:5]} launched (row 7, row 8, with mult) "
          f"{[steps[i][:3] for i in bad[:5]]}, expected (16, 16, 0)")
    val_batches = dm.steps_per_epoch("val")
    check(launches == {"forward": 16 * TRAIN_STEPS + 16 * val_batches,
                       "backward": 16 * TRAIN_STEPS, "mult": 0},
          f"FFHQ128 ViT fit: launches {launches}")
    copies = sum(s[3] for s in steps) / TRAIN_STEPS
    print("train FFHQ128 ViT total loss per step: " + ", ".join(f"{v:.4g}" for v in losses),
          flush=True)
    print(f"train FFHQ128 ViT bf16 full width, batch {VIT_TRAIN_BATCH}, lr {VIT_TRAIN_LR:g}: "
          f"{TRAIN_STEPS} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, val PSNR "
          f"{psnr:.3f} dB; launches per step 16 row 7 + 16 row 8 (run: {launches}, "
          f"{val_batches} validation batches); steady train img/s (steps 4-{TRAIN_STEPS}, "
          f"synchronised) {probe.img_s(VIT_TRAIN_BATCH):.1f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; dout copies per step "
          f"{copies:.1f}", flush=True)
    return launches



def _block_inputs(gen, b, t, h, ch, c, c_out, dtype, transposed: bool):
    """x and dout ~ N(0, 1) in ``dtype``; f32 weights at 1/sqrt(fan-in), as
    [out, in] matrices viewed transposed (the model's layout) or contiguous
    [in, out] (the JAX package's)."""
    width = h * ch
    x = torch.randn((b, t, c), generator=gen, device="cuda").to(dtype)
    dout = torch.randn((b, t, c_out), generator=gen, device="cuda").to(dtype)
    if transposed:
        wq = (torch.randn((3 * width, c), generator=gen, device="cuda") / math.sqrt(c)).t()
        wo = (torch.randn((c_out, width), generator=gen, device="cuda")
              / math.sqrt(width)).t()
    else:
        wq = torch.randn((c, 3 * width), generator=gen, device="cuda") / math.sqrt(c)
        wo = torch.randn((width, c_out), generator=gen, device="cuda") / math.sqrt(width)
    return x, wq, wo, dout


def _block_bound(b, t, h, ch, c, c_out, backward: bool):
    """(bound ms, bound_by, FLOP, bytes) of row 5 (or row 6) in bf16: the
    JAX cost estimates' FLOP (attention_pallas.py:577, :624) at the
    tensor-core rate; each input read once and each output written once."""
    width = h * ch
    w_bytes = 4 * (c * 3 * width + width * c_out)
    if backward:
        flops = b * (10.0 * t * t * width + 4.0 * t * c * 3 * width + 4.0 * t * width * c_out)
        n_bytes = 2 * b * t * (2 * c + c_out) + 4 * b * t * h + 2 * w_bytes
    else:
        flops = b * (4.0 * t * t * width + 2.0 * t * c * 3 * width + 2.0 * t * width * c_out)
        n_bytes = 2 * b * t * (c + c_out) + 4 * b * t * h + w_bytes
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms > ops_ms else "operations", flops, n_bytes


def phase_block(attention):
    """Rows 5 and 6 against their plain versions at BLOCK_SHAPES, bf16 and
    f32, and in bf16 at BLOCK_TILE_SHAPES, row 6 bit for bit on a second
    run; their times in bf16 at the FFHQ128 decoder's 32² block and the 16²
    encoder block, beside the bound, the plain versions and two yardsticks:
    the port's unfused block (two 1×1 convs around row 1, or their backward
    around row 2) and matmul + SDPA + matmul (PyTorch's library calls)."""
    from ot_vae_tpu_torch.networks.cnn import AttentionBlock

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(8642)
    worst = {"fwd": 0.0, "bwd": 0.0}
    # the path's weights are the convs' transposed views; the two ragged
    # shapes take the JAX package's contiguous layout
    shapes = [(*s, i < len(BLOCK_SHAPES) - 2) for i, s in enumerate(BLOCK_SHAPES)]
    repeats = 0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        for t, h, ch, c, c_out, b_fwd, b_bwd, transposed in shapes + (
                BLOCK_TILE_SHAPES if dtype == torch.bfloat16 else []):
            scale = 1.0 / math.sqrt(ch)
            shape = (f"T={t} H={h} ch={ch} C={c} C_out={c_out} "
                     f"{'transposed' if transposed else 'contiguous'} weights")
            x, wq, wo, _ = _block_inputs(gen, b_fwd, t, h, ch, c, c_out, dtype, transposed)
            out, lse = attention.attention_block(x, wq, wo, h, scale)
            torch.cuda.synchronize()
            ref, ref_lse = attention.attention_block_reference(x, wq, wo, h, scale)
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            rel = max_rel_err(out, ref, 1, SMALL_FLOOR)
            if dtype == torch.bfloat16:
                gate, ok = f"max_rel_err={rel:.3e} (tol {BF16_REL_TOL:.1e})", rel <= BF16_REL_TOL
            else:
                tol = OUT_TOL * max(1.0, ref.float().abs().max().item())
                gate, ok = f"(tol {tol:.3e}); max_rel_err={rel:.3e}", err <= tol
            print(f"block check {name} B={b_fwd} {shape}: out max_abs_err={err:.3e} {gate} "
                  f"lse max_abs_err={lse_err:.3e} (tol {LSE_TOL:.1e})", flush=True)
            check(math.isfinite(err) and ok, f"block {name} {shape}: abs {err}, rel {rel}")
            check(math.isfinite(lse_err) and lse_err <= LSE_TOL,
                  f"block {name} {shape}: lse {lse_err}")
            if dtype == torch.bfloat16:
                worst["fwd"] = max(worst["fwd"], err)
            del x, wq, wo, out, lse, ref, ref_lse

            x, wq, wo, dout = _block_inputs(gen, b_bwd, t, h, ch, c, c_out, dtype, transposed)
            _, lse = attention.attention_block(x, wq, wo, h, scale)
            grads = attention.attention_block_backward(x, wq, wo, lse, dout, h, scale)
            again = attention.attention_block_backward(x, wq, wo, lse, dout, h, scale)
            torch.cuda.synchronize()
            check(all(torch.equal(g, a) for g, a in zip(grads, again)),
                  f"block backward {name} {shape}: two runs differ")
            repeats += 1
            check(all(g.shape == w.shape and (min(w.shape) == 1 or g.stride() == w.stride())
                      for g, w in ((grads[1], wq), (grads[2], wo))),
                  f"block backward {name} {shape}: weight gradients not in the weights' "
                  f"layout")
            refs = attention.attention_block_backward_reference(x, wq, wo, lse, dout, h, scale)
            errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(grads, refs)]
            rels = [max_rel_err(g, r, n, SMALL_FLOOR)
                    for g, r, n in zip(grads, refs, (1, 3, 1))]
            if dtype == torch.bfloat16:
                gate = (f"max_rel_err dx {rels[0]:.3e} dW_qkv {rels[1]:.3e} dW_out "
                        f"{rels[2]:.3e} (tol {BF16_REL_TOL:.1e})")
                ok = max(rels) <= BF16_REL_TOL
            else:
                tols = [BWD_TOL * max(1.0, r.float().abs().max().item()) for r in refs]
                gate = (f"(tol {', '.join(f'{v:.3e}' for v in tols)}); max_rel_err "
                        f"{max(rels):.3e}")
                ok = all(e <= v for e, v in zip(errs, tols))
            print(f"block backward check {name} B={b_bwd} {shape}: max_abs_err dx "
                  f"{errs[0]:.3e} dW_qkv {errs[1]:.3e} dW_out {errs[2]:.3e} {gate}; "
                  f"repeats bit for bit", flush=True)
            check(all(math.isfinite(e) for e in errs) and ok,
                  f"block backward {name} {shape}: abs {errs}, rel {rels}")
            if dtype == torch.bfloat16:
                worst["bwd"] = max(worst["bwd"], max(errs))
            del x, wq, wo, dout, lse, grads, again, refs
    print(f"block backward: {repeats} checks repeated bit for bit", flush=True)

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dtype = torch.bfloat16
    timings = {}
    for t, h in ((1024, 2), (256, 4)):
        ch, c = HEAD_DIM, h * HEAD_DIM
        side = int(math.isqrt(t))
        scale = 1.0 / math.sqrt(ch)
        # the port's unfused block with the same weights: NCHW channels_last
        block = AttentionBlock(c, h, dtype=dtype).cuda()
        wq = block.Conv1x1_0.ConvLayer_0.EqualConv_0.Conv_0.weight.view(3 * c, c).t()
        wo = block.Conv1x1_1.ConvLayer_0.EqualConv_0.Conv_0.weight.view(c, c).t()
        wq_lib, wo_lib = (w.detach().to(dtype).requires_grad_() for w in (wq, wo))

        def library(x):
            qkv = torch.matmul(x, wq_lib)
            q, k, v = qkv.view(x.shape[0], t, 3, h, ch).permute(2, 0, 3, 1, 4)
            o = sdpa(q, k, v, scale=scale).transpose(1, 2).reshape(x.shape[0], t, c)
            return torch.matmul(o, wo_lib)

        for kind, b in (("fwd", BATCH), ("bwd", TRAIN_BATCH)):
            x = torch.randn((b, t, c), generator=gen, device="cuda").to(dtype)
            dout = torch.randn((b, t, c), generator=gen, device="cuda").to(dtype)
            bound, bound_by, flops, n_bytes = _block_bound(b, t, h, ch, c, c, kind == "bwd")
            x4 = x.view(b, side, side, c).permute(0, 3, 1, 2).detach().requires_grad_()
            dout4 = dout.view(b, side, side, c).permute(0, 3, 1, 2)
            xg = x.detach().requires_grad_()
            wq_d, wo_d = wq.detach(), wo.detach()
            if kind == "fwd":
                with torch.no_grad():
                    row = {
                        "ms": time_ms(lambda: attention.attention_block(x, wq_d, wo_d, h, scale),
                                      flush),
                        "plain_ms": time_ms(lambda: attention.attention_block_reference(
                            x, wq_d, wo_d, h, scale), flush, reps=10),
                        "unfused_ms": time_ms(lambda: block(x4), flush),
                        "matmul_sdpa_ms": time_ms(lambda: library(x), flush)}
            else:
                _, lse = attention.attention_block(x, wq_d, wo_d, h, scale)
                unfused_out = block(x4)
                library_out = library(xg)
                params = list(block.parameters())
                row = {
                    "ms": time_ms(lambda: attention.attention_block_backward(
                        x, wq_d, wo_d, lse, dout, h, scale), flush, reps=10),
                    "plain_ms": time_ms(lambda: attention.attention_block_backward_reference(
                        x, wq_d, wo_d, lse, dout, h, scale), flush, reps=5),
                    "unfused_ms": time_ms(lambda: torch.autograd.grad(
                        unfused_out, [x4] + params, dout4, retain_graph=True), flush, reps=10),
                    "matmul_sdpa_ms": time_ms(lambda: torch.autograd.grad(
                        library_out, (xg, wq_lib, wo_lib), dout, retain_graph=True), flush,
                        reps=10)}
                del lse, unfused_out, library_out
            row.update(bound_ms=bound, bound_by=bound_by, library_ms=None)
            timings[(kind, t, h)] = row
            print(f"block {'backward ' if kind == 'bwd' else ''}time bf16 B={b} T={t} H={h} "
                  f"ch={ch} C={c}: kernel {row['ms']:.4f} ms, bound {bound:.4f} ms "
                  f"({bound_by}; {flops:.3e} FLOP, {n_bytes / 1e6:.1f} MB; share "
                  f"{bound / row['ms']:.4f}), plain {row['plain_ms']:.4f} ms, library: no "
                  f"single PyTorch call; {flops / row['ms'] / 1e9:.1f} TFLOP/s", flush=True)
            print(f"block {kind} yardsticks bf16 B={b} T={t} H={h}: the port's unfused block "
                  f"(1x1 convs around row {1 if kind == 'fwd' else 2}) "
                  f"{row['unfused_ms']:.4f} ms; matmul + SDPA + matmul "
                  f"{row['matmul_sdpa_ms']:.4f} ms", flush=True)
            del x, dout, x4, dout4, xg
        del block, wq_lib, wo_lib
    del flush
    return worst, timings


def phase_fused_whole_path(attention, fused_engine, seed: int):
    """The fused-block model's weights in f32: served fused (6 row-5
    launches, no row 1) and unfused (6 row-1 launches, no row 5) on the card
    (TF32 off) and fused on the CPU (the plain rows 5 and 6), all three
    within PATH_TOL of each other."""
    from ot_vae_tpu_torch.serving import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = {k: v.cpu() for k, v in fused_engine.model.state_dict().items()}
    rng = np.random.default_rng(seed + 8)
    images = rng.uniform(0, 1, (4, 128, 128, 3)).astype(np.float32)
    noise = rng.standard_normal((4, 4, 4, 256)).astype(np.float32)
    outs = {}
    for name, device, fused in (("card fused", "cuda", True), ("card unfused", "cuda", False),
                                ("cpu fused", "cpu", True)):
        model = ffhq128_vae(torch.float32, seed, fused)
        model.load_state_dict(state, strict=True)
        attention.launch_count = attention.block_launch_count = 0
        outs[name] = InferenceEngine(model, device=device).reconstruct(images, noise=noise)
        want = (0, 0) if device == "cpu" else (0, 6) if fused else (6, 0)
        got = (attention.launch_count, attention.block_launch_count)
        check(got == want, f"whole path {name}: (row 1, row 5) launched {got}, expected {want}")
    ref = outs["cpu fused"]
    tol = PATH_TOL * max(1.0, float(np.abs(ref).max()))
    errs = {"card fused vs cpu fused": float(np.abs(outs["card fused"] - ref).max()),
            "card unfused vs cpu fused": float(np.abs(outs["card unfused"] - ref).max()),
            "card fused vs card unfused": float(np.abs(outs["card fused"]
                                                       - outs["card unfused"]).max())}
    print("whole path fused block f32, reconstruct 4: " + ", ".join(
        f"{k} max_abs_err={v:.3e}" for k, v in errs.items())
        + f" (tol {tol:.3e}, output range {np.abs(ref).max():.3f})", flush=True)
    check(all(np.isfinite(o).all() for o in outs.values())
          and all(v <= tol for v in errs.values()), f"whole path fused block: {errs} > {tol}")


def _ot_clouds(rng, n: int, d: int, scale, shift) -> np.ndarray:
    """n seeded samples of a correlated d-dimensional Gaussian: a random
    mixing of independent coordinates scaled by ``scale``, plus ``shift``."""
    mix = rng.standard_normal((d, d)) / math.sqrt(d)
    return (rng.standard_normal((n, d)) * scale) @ mix + shift


def _ot_fit(op, batches, device, dtype):
    """``op``'s state fitted from (source, target) batches on ``device`` in
    ``dtype``, then compute: (state, cost)."""
    state = op.init(torch.Generator(device=device).manual_seed(0))
    for src, tgt in batches:
        state = op.update(state, torch.as_tensor(src, device=device, dtype=dtype),
                          torch.as_tensor(tgt, device=device, dtype=dtype),
                          generator=torch.Generator(device=device).manual_seed(1))
    return op.compute(state)


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got − ref| over max(1, max |ref|), ref in f64 on the CPU."""
    ref = ref.double().cpu()
    return ((got.double().cpu() - ref).abs().max() / max(1.0, ref.abs().max().item())).item()


def phase_ot_core(seed: int, smi: str):
    """The OT core on the card at the MNIST32 gate's shapes: the Gaussian
    operator (D = 1024, 900 samples a side, eigh and polar) and the
    diagonal GMM operator (10 components, D = 64) fitted in f32 with TF32
    allowed, against the same port code in f64 on the CPU; the Newton–Schulz
    roots of the fitted covariance the same way; the card's results with
    TF32 allowed and forbidden bit for bit; compute and transport times."""
    from ot_vae_tpu_torch.ops import matrix
    from ot_vae_tpu_torch.transport import GaussianTransport, GMMTransport

    rng = np.random.default_rng(seed + 40)
    d = OT_GAUSSIAN_DIM
    scale_s, scale_t = rng.uniform(0.2, 2.0, d), rng.uniform(0.2, 2.0, d)
    source = _ot_clouds(rng, OT_SAMPLES, d, scale_s, 0.0)
    target = _ot_clouds(rng, OT_SAMPLES, d, scale_t, rng.standard_normal(d))
    batches = [(source[i:i + 50], target[i:i + 50]) for i in range(0, OT_SAMPLES, 50)]
    probe = torch.as_tensor(_ot_clouds(rng, 64, d, scale_s, 0.0))
    prev = torch.backends.cuda.matmul.allow_tf32
    results = {}
    try:
        # the flag is live on this card: a plain f32 product moves under it
        a = torch.as_tensor(rng.standard_normal((d, d)), device="cuda", dtype=torch.float32)
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = a @ a
        torch.backends.cuda.matmul.allow_tf32 = False
        control = _rel(tf32, a.double() @ a.double()), _rel(a @ a, a.double() @ a.double())
        for method in ("eigh", "polar"):
            op = GaussianTransport(dim=d, diag=False, make_pd=True, method=method)
            op64 = GaussianTransport(dim=d, diag=False, make_pd=True, method=method,
                                     dtype=torch.float64)
            ref, ref_cost = _ot_fit(op64, batches, "cpu", torch.float64)
            ref_moved = op64.transport(ref, probe)
            runs = []
            for allow in (True, False):
                torch.backends.cuda.matmul.allow_tf32 = allow
                state, cost = _ot_fit(op, batches, "cuda", torch.float32)
                moved = op.transport(state, probe.float().cuda())
                runs.append((state, cost, moved))
                check(torch.backends.cuda.matmul.allow_tf32 is allow,
                      "OT core: the caller's TF32 setting was not restored")
            torch.backends.cuda.matmul.allow_tf32 = True
            (state, cost, moved), (state_off, cost_off, moved_off) = runs
            same = (torch.equal(state.T, state_off.T) and torch.equal(cost, cost_off)
                    and torch.equal(moved, moved_off))
            x = probe.float().cuda()
            compute_ms = time_ms(lambda: op.compute(state), reps=3)
            transport_ms = time_ms(lambda: op.transport(state, x))
            results[f"gaussian_{method}"] = dict(
                T=_rel(state.T, ref.T), cost=abs(cost.item() - ref_cost.item())
                / abs(ref_cost.item()), moved=_rel(moved, ref_moved), same=same,
                compute_ms=compute_ms, transport_ms=transport_ms)
        # the Newton–Schulz roots of the source covariance the operator roots
        # (fitted and shrunk)
        cov64 = op64._fit(ref.source).cov
        cov32 = cov64.float().cuda()
        results["ns"] = dict(
            sqrtm=_rel(matrix.sqrtm(cov32, "ns"), matrix.sqrtm(cov64, "ns")),
            invsqrtm=_rel(matrix.invsqrtm(cov32, "ns"), matrix.invsqrtm(cov64, "ns")),
            ms=time_ms(lambda: matrix.sqrtm_and_invsqrtm(cov32, "ns"), reps=5),
            eigh_ms=time_ms(lambda: matrix.sqrtm_and_invsqrtm(cov32, "eigh"), reps=5))

        # the GMM operator: fitted on the card, its state handed to the CPU in
        # f64 (the k-means++ seeding draws from each device's own generator)
        dg = OT_GMM_DIM
        centers = rng.standard_normal((10, dg)) * 3.0
        gsrc = centers[rng.integers(0, 10, OT_SAMPLES)] + rng.standard_normal((OT_SAMPLES, dg))
        gtgt = (centers[rng.integers(0, 10, OT_SAMPLES)] * 1.5 + 1.0
                + 0.5 * rng.standard_normal((OT_SAMPLES, dg)))
        gop = GMMTransport(dim=dg, n_components=10, diag=True, transport_type="argmax",
                           kmeans_iter=0)
        gop64 = GMMTransport(dim=dg, n_components=10, diag=True, transport_type="argmax",
                             kmeans_iter=0, dtype=torch.float64)
        gbatches = [(gsrc[i:i + 50], gtgt[i:i + 50]) for i in range(0, OT_SAMPLES, 50)]
        gstate = gop.init(torch.Generator(device="cuda").manual_seed(0))
        gen = torch.Generator(device="cuda").manual_seed(1)
        for src, tgt in gbatches:
            gstate = gop.update(gstate, torch.as_tensor(src, device="cuda", dtype=torch.float32),
                                torch.as_tensor(tgt, device="cuda", dtype=torch.float32),
                                generator=gen)
        template = gop64.init(torch.Generator().manual_seed(0))
        gstate64 = type(template).from_arrays(gstate.to_arrays(), template, torch.device("cpu"))
        gx = torch.as_tensor(gsrc[:64])
        gfit, gcost = gop.compute(gstate)
        gref, gref_cost = gop64.compute(gstate64)
        gmoved, gref_moved = gop.transport(gfit, gx.float().cuda()), gop64.transport(gref, gx)
        gxc = gx.float().cuda()
        results["gmm"] = dict(
            plan=_rel(gfit.plan, gref.plan), cost=abs(gcost.item() - gref_cost.item())
            / abs(gref_cost.item()), moved=_rel(gmoved, gref_moved),
            compute_ms=time_ms(lambda: gop.compute(gstate), reps=3),
            transport_ms=time_ms(lambda: gop.transport(gfit, gxc)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.cuda.synchronize()
    print(f"OT core on the card ({smi}), f32 with TF32 allowed vs the port in f64 on the "
          f"CPU; TF32 is live here: a {d}² f32 product errs {control[0]:.3e} with it and "
          f"{control[1]:.3e} without (over max(1, max|ref|))", flush=True)
    for method in ("eigh", "polar"):
        r = results[f"gaussian_{method}"]
        print(f"OT core Gaussian D={d}, {OT_SAMPLES} samples a side, method={method}: T "
              f"{r['T']:.3e} (tol {OT_T_TOL[method]:.0e}), W2 rel {r['cost']:.3e} (tol "
              f"{OT_COST_RTOL:.0e}), transported 64 {r['moved']:.3e} (tol "
              f"{OT_T_TOL[method]:.0e}); TF32 allowed == forbidden bit for bit: {r['same']}; "
              f"compute {r['compute_ms']:.2f} ms, transport of 64 {r['transport_ms']:.4f} ms",
              flush=True)
        check(r["same"], f"OT core: Gaussian {method} differs with TF32 allowed")
        check(r["T"] <= OT_T_TOL[method] and r["cost"] <= OT_COST_RTOL
              and r["moved"] <= OT_T_TOL[method], f"OT core: Gaussian {method} {r}")
    r = results["ns"]
    print(f"OT core Newton-Schulz roots of the fitted {d}² covariance, f32 card vs f64 CPU: "
          f"sqrtm {r['sqrtm']:.3e}, invsqrtm {r['invsqrtm']:.3e} (tol {OT_NS_TOL:.0e}); "
          f"sqrtm_and_invsqrtm {r['ms']:.2f} ms (ns) vs {r['eigh_ms']:.2f} ms (eigh)",
          flush=True)
    check(r["sqrtm"] <= OT_NS_TOL and r["invsqrtm"] <= OT_NS_TOL, f"OT core: NS roots {r}")
    r = results["gmm"]
    print(f"OT core GMM 10 diagonal components, D={OT_GMM_DIM}, from the card's state: plan "
          f"{r['plan']:.3e} (tol {OT_PLAN_TOL:.0e}), MW2 rel {r['cost']:.3e} (tol "
          f"{OT_PLAN_TOL:.0e}), transported 64 {r['moved']:.3e} (tol {OT_GMM_TOL:.0e}); "
          f"compute {r['compute_ms']:.2f} ms, transport of 64 {r['transport_ms']:.4f} ms",
          flush=True)
    check(r["plan"] <= OT_PLAN_TOL and r["cost"] <= OT_PLAN_TOL and r["moved"] <= OT_GMM_TOL,
          f"OT core: GMM {r}")
    return results


def phase_cifar_vit_transport(attention, seed: int, workdir: Path):
    """The conditional CIFAR10 ViT gate (tests/test_conditional_vit_vae.py):
    the full-width model of configs/vae/vit.yaml for 8 epochs of 2500
    seeded synthetic images with the blur curriculum and a Gaussian
    LatentTransport whose target streams from training (EMA 0.995, kept
    across validations); test and transport PSNR against the gate's
    floors, and the launches of rows 7 and 8."""
    from ot_vae_tpu_torch.data import CIFAR10, GaussianBlur
    from ot_vae_tpu_torch.data.progressive import PgTransform, ProgressiveTransform
    from ot_vae_tpu_torch.transport import GaussianTransport, LatentTransport

    dm = CIFAR10(train_batch_size=CIFAR_TRAIN_BATCH, val_batch_size=50, test_batch_size=50,
                 seed=42, synthetic_train=2500, synthetic_test=600)
    dm.setup()
    model = cifar_vit_vae(seed)
    cb = LatentTransport(
        size=model.latent_size, transport_dims=(2,), transformations=GaussianBlur(5, sigma=1.5),
        transport_operator=GaussianTransport, logging_prefix="embed_token",
        source_latents_from_train=False, target_latents_from_train=True, unpaired=True,
        common_operator=True, num_samples_to_log=4,
        operator_kwargs=dict(diag=False, make_pd=True, reset_target=False, update_decay=0.995))
    curriculum = ProgressiveTransform(PgTransform(GaussianBlur, [(5, 1.0), (5, 0.5)]))
    start = time.perf_counter()
    trainer, probe, _, losses, val_psnr, launches = _fit(
        attention, model, dm, workdir / "cifar_vit_transport", 42, callbacks=[curriculum, cb],
        max_epochs=CIFAR_TRANSPORT_EPOCHS)
    fit_s = time.perf_counter() - start
    logger = trainer.logger
    before = (attention.bthd_launch_count, attention.bthd_bwd_launch_count)
    test = trainer.test(model, dm)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - start
    test_launches = (attention.bthd_launch_count - before[0],
                     attention.bthd_bwd_launch_count - before[1])
    transport_psnr = cb.compute_test_metrics().get(cb.logging_prefix_full + "psnr")
    psnr = test.get("test/metrics/psnr")
    n_steps, val_batches = dm.steps_per_epoch("train"), dm.steps_per_epoch("val")
    test_batches = dm.steps_per_epoch("test")
    costs = [m[cb.logging_prefix_full + "avg_transport_cost"] for _, m in logger.rows
             if cb.logging_prefix_full + "avg_transport_cost" in m]
    first, last = statistics.mean(losses[:20]), statistics.mean(losses[-20:])
    print(f"CIFAR10 ViT transport gate: {CIFAR_TRANSPORT_EPOCHS} epochs x {n_steps} steps, "
          f"loss (mean of 20) {first:.4f} -> {last:.4f}, val PSNR {val_psnr:.3f} dB; test PSNR "
          f"{psnr:.3f} dB, transported (blur -> transport) PSNR {transport_psnr:.3f} dB (floors "
          f"{CIFAR_TRANSPORT_PSNR} dB); transport costs {costs}; launches fit {launches}, "
          f"test {test_launches}; fit {fit_s:.1f} s, fit + test {run_s:.1f} s", flush=True)
    check(all(math.isfinite(v) for v in losses) and last < first,
          f"CIFAR10 ViT transport: loss {first} -> {last}")
    check(len(costs) == CIFAR_TRANSPORT_EPOCHS and all(math.isfinite(c) for c in costs),
          f"CIFAR10 ViT transport: costs {costs}")
    check(psnr is not None and psnr > CIFAR_TRANSPORT_PSNR and transport_psnr is not None
          and transport_psnr > CIFAR_TRANSPORT_PSNR,
          f"CIFAR10 ViT transport: test PSNR {psnr}, transported {transport_psnr}, floors "
          f"{CIFAR_TRANSPORT_PSNR}")
    steps = probe.steps()
    bad = [i for i, st in enumerate(steps) if st[:3] != (6, 6, 12)]
    check(len(steps) == CIFAR_TRANSPORT_EPOCHS * n_steps and not bad,
          f"CIFAR10 ViT transport: steps {bad[:5]} launched (row 7, row 8, with mult) "
          f"{[steps[i][:3] for i in bad[:5]]}, expected (6, 6, 12)")
    # a validation batch: the eval step (encoder and decoder, 3 blocks each)
    # and the callback's encode of the blurred batch; each validation's
    # collage: one encode and four decodes; a test batch: the eval step,
    # the callback's encode and decode
    want = {"forward": 6 * CIFAR_TRANSPORT_EPOCHS * n_steps
            + CIFAR_TRANSPORT_EPOCHS * (9 * val_batches + 15),
            "backward": 6 * CIFAR_TRANSPORT_EPOCHS * n_steps,
            "mult": 12 * CIFAR_TRANSPORT_EPOCHS * n_steps}
    check(launches == want and test_launches == (12 * test_batches, 0),
          f"CIFAR10 ViT transport: launches {launches}, test {test_launches}, expected "
          f"{want}, ({12 * test_batches}, 0)")
    _check_collages("CIFAR10 ViT transport", logger, cb, CIFAR_TRANSPORT_EPOCHS,
                    (6 * 32, 4 * 32, 3))
    return {"forward": launches["forward"] + test_launches[0],
            "backward": launches["backward"]}


def auto_diffusion_model(seed: int, dtype=torch.float32):
    """The AutoDiffusion gate's model (tests/test_auto_diffusion.py): the
    AutoEncoder (capacity 8, latent 2 x 2 x 64 doubled, time embedding of
    32) with a Gaussian prior, 5 sampler steps, PSNR; its initial weights
    those the JAX package's Trainer(seed=seed) draws for it."""
    from ot_vae_tpu_torch.jax_init import load_jax_trainer_init
    from ot_vae_tpu_torch.metrics import PSNR, MetricCollection
    from ot_vae_tpu_torch.models import AutoDiffusion
    from ot_vae_tpu_torch.networks import AutoEncoder
    from ot_vae_tpu_torch.priors import GaussianPrior

    torch.manual_seed(seed)
    ae = AutoEncoder(1, 64, 32, 2, capacity=8, down_up_sample=True, residual="add",
                     time_embed_dim=32, double_encoded_features=True, dtype=dtype)
    model = AutoDiffusion(metrics=MetricCollection({"psnr": PSNR()}), autoencoder=ae,
                          prior=GaussianPrior(loss_coeff=0.1), n_steps=AD_N_STEPS)
    load_jax_trainer_init(model.net, seed)
    return model


def dad_model(seed: int, dtype=torch.float32):
    """configs/dad/defaults.yaml's model, built in code with that file's
    arguments and dropout 0.1 (tests/test_dad.py): ViT encoder and decoder
    (28², patch 7, 16 tokens, dim 64, depth 2, 4 heads), a learned shared
    codebook of 128 atoms (Gumbel-softmax in training, sampled in
    inference, temperature annealed over 2000 steps), the causal
    AutoRegressive decoder over its indices; PSNR."""
    from ot_vae_tpu_torch.metrics import PSNR, MetricCollection
    from ot_vae_tpu_torch.models import DAD
    from ot_vae_tpu_torch.networks import AutoRegressive, ViT
    from ot_vae_tpu_torch.priors import CodebookPrior

    torch.manual_seed(seed)
    vit = dict(image_size=28, patch_size=7, dim=64, depth=2, heads=4, channels=1,
               dropout=0.1, dtype=dtype)
    encoder = ViT(n_embed_tokens=0, output_tokens="input", patch_to_embed=True,
                  embed_to_patch=False, **vit)
    n_tokens = encoder.total_num_tokens
    decoder = ViT(n_embed_tokens=None, n_input_tokens=n_tokens, output_tokens="input",
                  patch_to_embed=False, embed_to_patch=True, **vit)
    prior = CodebookPrior(latent_size=encoder.out_size, embed_dims=(2,), n_components=128,
                          temperature=1e-5, training_mode="gumbel-softmax",
                          inference_mode="sample", temperature_annealing=2000,
                          update_with_autograd=True)
    ar = AutoRegressive(vocab_size=prior.num_embeddings, n_embed_tokens=0,
                        n_input_tokens=n_tokens, output_tokens="input", patch_to_embed=False,
                        causal_mask=True, **vit)
    return DAD(metrics=MetricCollection({"psnr": PSNR()}), encoder=encoder, decoder=decoder,
               autoregressive_decoder=ar, prior=prior)


def _counted(read, fn):
    """(fn(), the differences of ``read()`` across it), synchronised."""
    torch.cuda.synchronize()
    before = read()
    out = fn()
    torch.cuda.synchronize()
    return out, tuple(b - a for a, b in zip(before, read()))


def _cuda_gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def _engine_matches(name, model, n: int, seed: int, shape):
    """InferenceEngine.sample against the model's own sampler (the engine's
    inference transforms on both) for one generator; the error."""
    from ot_vae_tpu_torch.serving import InferenceEngine

    engine = InferenceEngine(model)
    with torch.no_grad():
        want = model.sample(n, _cuda_gen(seed)).float().cpu().numpy()
    got = engine.sample(n, _cuda_gen(seed))
    err = float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))
    check(got.shape == (n, *shape) and bool(np.isfinite(got).all())
          and err <= ENGINE_SAMPLE_TOL, f"{name}: engine.sample vs the model's sampler {err}")
    return err


def _auto_diffusion_gate_run(attention, dm, seed: int, counts, workdir: Path):
    """One run of the AutoDiffusion gate: the JAX gate's initial weights,
    Trainer.fit with ``seed`` keying the trainer's draws, and Trainer.test;
    checks its losses and launches and returns (model, test PSNR, fit
    launches, test launches)."""
    start = time.perf_counter()
    model = auto_diffusion_model(AD_WEIGHTS_SEED)
    check(tuple(model.latent_size) == (2, 2, 64), f"AutoDiffusion latent {model.latent_size}")
    trainer, probe, _, losses, val_psnr, _ = _fit(
        attention, model, dm, workdir / f"auto_diffusion_{seed}", seed, max_epochs=AD_EPOCHS,
        read=counts, check_val_every_n_epoch=AD_EPOCHS)
    fit = counts()
    test, tested = _counted(counts, lambda: trainer.test(model, dm))
    run_s = time.perf_counter() - start
    psnr = test.get("test/metrics/psnr", float("nan"))
    n_steps = dm.steps_per_epoch("train")
    val_batches, test_batches = dm.steps_per_epoch("val"), dm.steps_per_epoch("test")
    first, last = statistics.mean(losses[:20]), statistics.mean(losses[-20:])
    print(f"AutoDiffusion gate, the JAX weights of seed {AD_WEIGHTS_SEED}, trainer seed {seed}: "
          f"{AD_EPOCHS} epochs x {n_steps} steps "
          f"at batch 50, loss (mean of 20) {first:.4f} -> {last:.4f}, val PSNR "
          f"{val_psnr:.3f} dB, test PSNR {psnr:.3f} dB; launches (row 1, row 2, rows 7+8) "
          f"fit {fit}, test {tested}; fit + test {run_s:.1f} s", flush=True)
    check(all(math.isfinite(v) for v in losses) and last < first,
          f"AutoDiffusion seed {seed}: loss {first} -> {last}")
    # 4 attention blocks in each CNN (16² to 2²): a step runs 8 forward and
    # 8 backward; a validation or test batch the encoder once and the decoder
    steps = probe.steps()
    bad = [i for i, st in enumerate(steps) if st != (8, 8, 0)]
    check(len(steps) == AD_EPOCHS * n_steps and not bad,
          f"AutoDiffusion seed {seed}: steps {bad[:5]} launched "
          f"{[steps[i] for i in bad[:5]]}, expected (8, 8, 0)")
    check(fit == (8 * AD_EPOCHS * n_steps + 8 * val_batches, 8 * AD_EPOCHS * n_steps, 0)
          and tested == (8 * test_batches, 0, 0),
          f"AutoDiffusion seed {seed}: launches fit {fit}, test {tested}")
    return model, psnr, fit, tested


def phase_auto_diffusion(attention, seed: int, workdir: Path):
    """The AutoDiffusion gate whole (tests/test_auto_diffusion.py): five
    runs of Trainer.fit (4 epochs) and Trainer.test from the JAX gate's
    initial weights, trainer seeds 42 + s .. 46 + s, whose median test PSNR
    must pass the gate's floor; on the median run's model the diffusion
    sampler with both algorithms and with
    return_steps, served through InferenceEngine; the launches of rows 1
    and 2 per step, validation and test batch and sampler call."""
    from ot_vae_tpu_torch.data import MNIST32

    def counts():
        return (attention.launch_count, attention.backward_launch_count,
                attention.bthd_launch_count + attention.bthd_bwd_launch_count)

    start = time.perf_counter()
    dm = MNIST32(train_batch_size=50, val_batch_size=50, test_batch_size=50, seed=42,
                 synthetic_train=3000, synthetic_test=500)
    dm.setup()
    trainer_seeds = [AD_WEIGHTS_SEED + seed + i for i in range(AD_RUNS)]
    runs = [_auto_diffusion_gate_run(attention, dm, s, counts, workdir) for s in trainer_seeds]
    psnrs = [r[1] for r in runs]
    median = sorted(range(AD_RUNS), key=lambda i: psnrs[i])[AD_RUNS // 2]
    print(f"AutoDiffusion gate: test PSNR {[round(p, 3) for p in psnrs]} from the JAX weights "
          f"of seed {AD_WEIGHTS_SEED} under trainer seeds {trainer_seeds}, median "
          f"{psnrs[median]:.3f} dB (floor {AD_PSNR} dB)", flush=True)
    check(math.isfinite(psnrs[median]) and psnrs[median] > AD_PSNR,
          f"AutoDiffusion: median test PSNR {psnrs[median]} over {psnrs}, floor {AD_PSNR}")
    model = runs[median][0]

    model.net.eval()
    sample_launches = 0
    times = {}
    with torch.no_grad():
        for improved in (False, True):
            out, n = _counted(counts, lambda: model.net.diffusion_sample(
                8, _cuda_gen(seed), improved_algorithm=improved))
            per_step = 12 if improved else 8  # decode 4, encode 4 (twice improved)
            check(tuple(out.shape) == (8, 32, 32, 1) and bool(torch.isfinite(out).all())
                  and n == (AD_N_STEPS * per_step, 0, 0),
                  f"AutoDiffusion sampler improved={improved}: {tuple(out.shape)}, "
                  f"launches {n}")
            sample_launches += n[0]
            times["improved" if improved else "standard"] = time_ms(
                lambda: model.net.diffusion_sample(8, _cuda_gen(seed),
                                                   improved_algorithm=improved), reps=5)
        steps_out, n = _counted(counts, lambda: model.net.diffusion_sample(
            4, _cuda_gen(seed + 1), return_steps=True))
        check(len(steps_out) == AD_N_STEPS
              and all(tuple(x.shape) == (4, 32, 32, 1) for x in steps_out)
              and n == (8 * AD_N_STEPS, 0, 0),
              f"AutoDiffusion return_steps: {len(steps_out)} images, launches {n}")
        sample_launches += n[0]
    # served images are cropped back to 28² by MNIST32's inference transform
    err, n = _counted(counts, lambda: _engine_matches("AutoDiffusion", model, 8, seed + 2,
                                                      (28, 28, 1)))
    check(n == (2 * 8 * AD_N_STEPS, 0, 0), f"AutoDiffusion engine.sample: launches {n}")
    sample_launches += n[0]
    print(f"AutoDiffusion sampler, 8 images of 32 x 32 x 1, {AD_N_STEPS} steps: standard "
          f"{times['standard']:.3f} ms, improved {times['improved']:.3f} ms; row-1 launches "
          f"40 / 60 a call, 40 with return_steps (4 images); engine.sample vs the model's "
          f"sampler {err:.3e} (tol {ENGINE_SAMPLE_TOL:.0e}); phase "
          f"{time.perf_counter() - start:.1f} s",
          flush=True)
    return {"train": (sum(r[2][0] + r[3][0] for r in runs), sum(r[2][1] for r in runs)),
            "sample": sample_launches}


def _dad_counts(attention):
    """The counters the DAD gate reads: row 7, row 8, launches with a
    multiplier, causal launches, rows 1 + 2."""
    return (attention.bthd_launch_count, attention.bthd_bwd_launch_count,
            attention.mult_launch_count, attention.causal_launch_count,
            attention.launch_count + attention.backward_launch_count)


def _dad_gate_run(attention, dm, seed: int, workdir: Path):
    """One run of the DAD gate with weights from ``seed``: Trainer.fit of 8
    epochs and Trainer.test; checks its losses and launches and returns
    (model, test PSNR, fit launches, test launches)."""
    start = time.perf_counter()
    model = dad_model(seed)
    check(tuple(model.latent_size) == (16, 64) and model.n_tokens == 16,
          f"DAD latent {model.latent_size}")
    trainer, probe, _, losses, val_psnr, launches = _fit(
        attention, model, dm, workdir / f"dad_{seed}", 42, max_epochs=DAD_EPOCHS,
        check_val_every_n_epoch=DAD_EPOCHS)
    causal = attention.causal_launch_count
    test, tested = _counted(lambda: _dad_counts(attention), lambda: trainer.test(model, dm))
    run_s = time.perf_counter() - start
    psnr = test.get("test/metrics/psnr", float("nan"))
    n_steps = dm.steps_per_epoch("train")
    val_batches, test_batches = dm.steps_per_epoch("val"), dm.steps_per_epoch("test")
    first, last = statistics.mean(losses[:20]), statistics.mean(losses[-20:])
    print(f"DAD gate, weights from seed {seed}: {DAD_EPOCHS} epochs x {n_steps} steps at "
          f"batch 50, dropout 0.1, loss (mean of 20) {first:.4f} -> {last:.4f}, val PSNR "
          f"{val_psnr:.3f} dB, test PSNR {psnr:.3f} dB (floor {DAD_PSNR} dB); launches fit "
          f"{launches}, causal {causal}, test (row 7, row 8, mult, causal, rows 1+2) "
          f"{tested}; fit + test {run_s:.1f} s", flush=True)
    check(all(math.isfinite(v) for v in losses) and last < first,
          f"DAD: loss {first} -> {last}")
    # a step: the encoder, decoder and AR stack, 2 layers each, every launch
    # with the multiplier (dropout 0.1), the AR stack's causal; a validation
    # or test batch: the encoder once and the decoder
    steps = probe.steps()
    bad = [i for i, st in enumerate(steps) if st[:3] != (6, 6, 12) or st[4] != 4]
    check(len(steps) == DAD_EPOCHS * n_steps and not bad,
          f"DAD: steps {bad[:5]} launched (row 7, row 8, mult, copies, causal) "
          f"{[steps[i] for i in bad[:5]]}, expected (6, 6, 12, *, 4)")
    check(launches == {"forward": 6 * DAD_EPOCHS * n_steps + 4 * val_batches,
                       "backward": 6 * DAD_EPOCHS * n_steps,
                       "mult": 12 * DAD_EPOCHS * n_steps}
          and causal == 4 * DAD_EPOCHS * n_steps and tested == (4 * test_batches, 0, 0, 0, 0),
          f"DAD: launches fit {launches}, causal {causal}, test {tested}")
    return model, psnr, launches, tested


def phase_dad(attention, seed: int, workdir: Path):
    """The DAD gate whole (tests/test_dad.py, configs/dad/defaults.yaml's
    model): Trainer.fit of 8 epochs, Trainer.test, 4 samples through
    model.sample, the KV-cached sampler against the unrolled oracle, served
    through InferenceEngine; the launches of rows 7 and 8 per step (with the
    multiplier, causal), per validation and test batch and per sample."""
    from ot_vae_tpu_torch.data import MNIST

    def counts():
        return _dad_counts(attention)

    start = time.perf_counter()
    dm = MNIST(train_batch_size=50, val_batch_size=50, test_batch_size=50, seed=42,
               synthetic_train=2500, synthetic_test=600)
    dm.setup()
    model, psnr, launches, tested = _dad_gate_run(attention, dm, seed, workdir)
    check(math.isfinite(psnr) and psnr > DAD_PSNR, f"DAD: test PSNR {psnr}, floor {DAD_PSNR}")

    model.net.eval()
    model.inference = True
    sample_launches = 0
    with torch.no_grad():
        samples, n = _counted(counts, lambda: model.sample(4, _cuda_gen(seed)))
        check(tuple(samples.shape) == (4, 28, 28, 1) and bool(torch.isfinite(samples).all())
              and n == (4, 0, 0, 2, 0), f"DAD samples: {tuple(samples.shape)}, launches {n}")
        sample_launches += n[0]
        # the cached sampler: a full-length AR decode call (2 causal
        # launches), 15 single-token steps on the plain path (none), the
        # decoder (2); the oracle: 15 full AR forwards (30 causal) and the
        # decoder
        fast, n_fast = _counted(counts, lambda: model.net.cached_sample(8, _cuda_gen(seed + 3)))
        slow, n_slow = _counted(counts, lambda: model.net.ancestral_sample(
            8, _cuda_gen(seed + 3)))
        err = (fast - slow).abs().max().item()
        check(n_fast == (4, 0, 0, 2, 0) and n_slow == (32, 0, 0, 30, 0),
              f"DAD samplers: launches cached {n_fast}, oracle {n_slow}")
        check(bool(torch.isfinite(fast).all()) and err <= DAD_SAMPLER_ATOL,
              f"DAD: cached sampler vs the oracle {err}")
        sample_launches += n_fast[0] + n_slow[0]
        times = {name: time_ms(lambda: fn(8, _cuda_gen(seed + 3)), reps=5)
                 for name, fn in (("cached", model.net.cached_sample),
                                  ("oracle", model.net.ancestral_sample))}
    engine_err, n = _counted(counts, lambda: _engine_matches("DAD", model, 4, seed + 4,
                                                             (28, 28, 1)))
    check(n == (8, 0, 0, 4, 0), f"DAD engine.sample: launches {n}")
    sample_launches += n[0]
    print(f"DAD sampler, 8 images: cached {times['cached']:.3f} ms, oracle "
          f"{times['oracle']:.3f} ms; cached vs oracle max abs {err:.3e} (atol "
          f"{DAD_SAMPLER_ATOL:.0e}); row-7 launches a call 4 cached (2 causal) and 32 oracle "
          f"(30 causal); engine.sample vs the model's sampler {engine_err:.3e}; phase "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    return {"train": (launches["forward"] + tested[0], launches["backward"]),
            "sample": sample_launches}


def phase_slice7_train_card_vs_cpu(seed: int):
    """Both slice-7 models' first two train steps at batch 4 from the same
    weights, images, t, ε, Gumbel noise, sampled indices and dropout masks
    (drawn on the CPU and replayed): f32 on the CPU, on the card (TF32 off)
    and in f64 on the CPU, as phases 7 and 19."""
    from ot_vae_tpu_torch.data import ArrayDataset, BaseDatamodule
    from ot_vae_tpu_torch.trainer import Trainer

    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed + 8)
    cases = [("AutoDiffusion", auto_diffusion_model, 32, (2, 2, 64)),
             ("DAD", dad_model, 28, None)]
    for name, build, size, latent in cases:
        images = [rng.uniform(0, 1, (4, size, size, 1)).astype(np.float32) for _ in range(2)]
        labels = np.zeros(4, np.int32)
        times = [rng.uniform(0, 1, 4).astype(np.float32) for _ in images]
        noise = [None if latent is None else rng.standard_normal((4, *latent)).astype(np.float32)
                 for _ in images]
        state = build(seed + 9).state_dict()
        runs = {}
        with DrawTape() as tape:
            for run, device, dtype in (("cpu", "cpu", torch.float32),
                                       ("card", "cuda", torch.float32),
                                       ("cpu64", "cpu", torch.float64)):
                tape.rewind()
                model = build(seed + 9, dtype)
                model.load_state_dict(state, strict=True)
                model.to(dtype)
                if latent is not None:  # AutoDiffusion: hand t across
                    _with_times(model, times)
                trainer = Trainer(device=device, seed=seed)
                trainer.setup_fit(model, BaseDatamodule(
                    train_dataset=ArrayDataset(images[0], labels)))
                losses, grads = [], None
                for i, (x, eps) in enumerate(zip(images, noise)):
                    logs, _ = trainer.train_step(model, (x, labels),
                                                 trainer.generator(1, 0, i), noise=eps,
                                                 dropout_rng=trainer.generator(4, 0, i))
                    losses.append(float(logs["train/loss/total"]))
                    if grads is None:
                        grads = {k: p.grad.detach().double().cpu()
                                 for k, p in model.net.named_parameters()
                                 if p.grad is not None}
                runs[run] = (losses, grads)
            drawn = {k: len(v) for k, v in tape.draws.items()}
        _check_train_runs(f"{name}: draws handed across {drawn}", runs)
    print(f"slice 7 train card vs CPU: {time.perf_counter() - start:.1f} s", flush=True)


def _with_times(model, times):
    """Makes ``model.batch_preprocess`` set each batch's t to the next of
    ``times``, so every run of phase 30 trains on the same t."""
    queue, preprocess = list(times), model.batch_preprocess

    def with_time(batch, train: bool = True, generator=None):
        pbatch = preprocess(batch, train, generator)
        t = torch.from_numpy(queue.pop(0)).to(pbatch["samples"].device)
        pbatch["kwargs"] = {**pbatch["kwargs"], "time": t}
        return pbatch

    model.batch_preprocess = with_time


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
    from ot_vae_tpu_torch.ops import _build, attention, sinkhorn

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
        launches, engine, serve_rates, _ = phase_serve(attention, sinkhorn, args.seed)
        phase_whole_path(engine, args.seed)
        del engine
        bwd_worst, bwd_timings = phase_backward(attention)
        phase_train_card_vs_cpu(args.seed)
        workdir = ROOT / "build" / "chip_smoke"
        shutil.rmtree(workdir, ignore_errors=True)
        model, checkpoint, train_launches, train_stats = phase_train(
            attention, sinkhorn, args.seed, workdir)
        phase_serve_checkpoint(model, checkpoint, args.seed)
        shutil.rmtree(workdir, ignore_errors=True)
        del model
        small_worst = phase_small_heads(attention)
        sk_worst, sk_timings = phase_sinkhorn(sinkhorn)
        sk_timing = sk_timings[(1, 256, 256)]
        transport_launches = phase_mnist32_transport(attention, sinkhorn, args.seed, workdir)
        shutil.rmtree(workdir, ignore_errors=True)
        vae_launches = phase_mnist32_vae(attention, args.seed)
        bthd_worst, bthd_timings, bhtc_launches = phase_bthd(attention)
        cifar_launches, cifar_engine = phase_serve_cifar_vit(attention, args.seed)
        ffhq_launches, ffhq_engine = phase_serve_ffhq_vit(attention, args.seed)
        phase_vit_whole_path(cifar_engine, ffhq_engine, args.seed)
        del cifar_engine, ffhq_engine
        bwd_bthd_worst, bwd_bthd_timings, bhtc_bwd_launches = phase_bthd_backward(attention)
        phase_vit_train_card_vs_cpu(args.seed)
        cifar_train = phase_train_cifar_vit(attention, args.seed, workdir)
        ffhq_train = phase_train_ffhq_vit(attention, args.seed, workdir)
        shutil.rmtree(workdir, ignore_errors=True)
        block_worst, block_timings = phase_block(attention)
        fused_launches, fused_engine, fused_rates, fused_serve_others = phase_serve(
            attention, sinkhorn, args.seed, fused=True)
        print("serve img/s at bucket 64 (bf16), fused block vs unfused (phase 4): " + ", ".join(
            f"{k} {fused_rates[k]:.1f} vs {serve_rates[k]:.1f}" for k in serve_rates),
            flush=True)
        phase_fused_whole_path(attention, fused_engine, args.seed)
        del fused_engine
        phase_train_card_vs_cpu(args.seed, fused=True)
        model, _, fused_train, fused_stats = phase_train(attention, sinkhorn, args.seed,
                                                        workdir, fused=True)
        del model
        shutil.rmtree(workdir, ignore_errors=True)
        print(f"train FFHQ128 bf16 batch {TRAIN_BATCH}, fused block vs unfused (phase 8): "
              f"steady img/s {fused_stats['img_s']:.1f} vs {train_stats['img_s']:.1f}; peak "
              f"memory {fused_stats['peak_gib']:.2f} vs {train_stats['peak_gib']:.2f} GiB; "
              f"dout copies per step {fused_stats['copies']:.1f} vs "
              f"{train_stats['copies']:.1f}", flush=True)
        phase_ot_core(args.seed, smi)
        cifar_transport = phase_cifar_vit_transport(attention, args.seed, workdir)
        shutil.rmtree(workdir, ignore_errors=True)
        auto_diffusion = phase_auto_diffusion(attention, args.seed, workdir)
        dad = phase_dad(attention, args.seed, workdir)
        shutil.rmtree(workdir, ignore_errors=True)
        phase_slice7_train_card_vs_cpu(args.seed)
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    main_shape, bwd_shape = timings[(1024, 2)], bwd_timings[(1024, 2)]
    kernels = [{
        "name": "attention_packed_fwd",
        "route": "cuda",
        "source": "ot_vae_tpu_torch/ops/csrc/attention_packed.cu",
        "replaces": "ot_vae_tpu/ops/attention_pallas.py:255",
        "launches": (launches + train_launches["forward"] + transport_launches[0]
                     + vae_launches[0] + auto_diffusion["train"][0]
                     + auto_diffusion["sample"]),
        "launches_by_path": {"serve": launches, "train": train_launches["forward"],
                             "mnist32_transport": transport_launches[0],
                             "mnist32_vae": vae_launches[0], "vit_cifar10_serve": 0,
                             "vit_ffhq128_serve": 0,
                             "auto_diffusion_train": auto_diffusion["train"][0],
                             "auto_diffusion_sample": auto_diffusion["sample"],
                             "dad_train": 0, "dad_sample": 0},
        "max_abs_err": max(worst[torch.bfloat16], small_worst[("out", torch.bfloat16)]),
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
        "launches": (train_launches["backward"] + transport_launches[1] + vae_launches[1]
                     + auto_diffusion["train"][1]),
        "launches_by_path": {"serve": 0, "train": train_launches["backward"],
                             "mnist32_transport": transport_launches[1],
                             "mnist32_vae": vae_launches[1],
                             "auto_diffusion_train": auto_diffusion["train"][1],
                             "auto_diffusion_sample": 0, "dad_train": 0},
        "max_abs_err": max(bwd_worst[torch.bfloat16], small_worst[("dqkv", torch.bfloat16)]),
        "ms": bwd_shape["ms"],
        "plain_ms": bwd_shape["plain_ms"],
        "bound_ms": bwd_shape["bound_ms"],
        "bound_by": bwd_shape["bound_by"],
        "library_ms": bwd_shape["library_ms"],
    }, {
        "name": "sinkhorn_log",
        "route": "cuda",
        "source": "ot_vae_tpu_torch/ops/csrc/sinkhorn_log.cu",
        "replaces": "ot_vae_tpu/ops/sinkhorn_pallas.py:39",
        "launches": transport_launches[2],
        "launches_by_path": {"mnist32_transport": transport_launches[2]},
        "max_abs_err": sk_worst,
        "ms": sk_timing["ms"],
        "plain_ms": sk_timing["plain_ms"],
        "bound_ms": sk_timing["bound_ms"],
        "bound_by": sk_timing["bound_by"],
        "library_ms": None,
    }]
    for kind, source_line, launches_by_path in (
            ("bthd", "ot_vae_tpu/ops/attention_pallas.py:676",
             {"vit_cifar10_serve": cifar_launches, "vit_ffhq128_serve": ffhq_launches,
              "vit_cifar10_train": cifar_train["forward"],
              "vit_ffhq128_train": ffhq_train["forward"],
              "vit_cifar10_transport": cifar_transport["forward"],
              "auto_diffusion_train": 0, "auto_diffusion_sample": 0,
              "dad_train": dad["train"][0], "dad_sample": dad["sample"]}),
            ("bhtc", "ot_vae_tpu/ops/attention_pallas.py:109",
             {"vit_cifar10_serve": 0, "vit_ffhq128_serve": 0, "vit_cifar10_train": 0,
              "vit_ffhq128_train": 0, "vit_cifar10_transport": 0, "dad_train": 0,
              "dad_sample": 0, "fused_attention_entry": bhtc_launches})):
        row = bthd_timings[(kind, 4)]  # the FFHQ128 ViT encoder's layer
        kernels.append({
            "name": f"attention_{kind}_fwd",
            "route": "cuda",
            "source": "ot_vae_tpu_torch/ops/csrc/attention_bthd.cu",
            "replaces": source_line,
            "launches": sum(launches_by_path.values()),
            "launches_by_path": launches_by_path,
            "max_abs_err": bthd_worst[kind],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    for kind, source_line, launches_by_path in (
            ("bthd", "ot_vae_tpu/ops/attention_pallas.py:710",
             {"vit_cifar10_train": cifar_train["backward"],
              "vit_ffhq128_train": ffhq_train["backward"],
              "vit_cifar10_transport": cifar_transport["backward"],
              "auto_diffusion_train": 0, "dad_train": dad["train"][1]}),
            ("bhtc", "ot_vae_tpu/ops/attention_pallas.py:130",
             {"vit_cifar10_train": 0, "vit_ffhq128_train": 0, "vit_cifar10_transport": 0,
              "dad_train": 0, "fused_attention_entry": bhtc_bwd_launches})):
        row = bwd_bthd_timings[(kind, 4)]  # the FFHQ128 ViT encoder's layer, batch 32
        kernels.append({
            "name": f"attention_{kind}_bwd",
            "route": "cuda",
            "source": "ot_vae_tpu_torch/ops/csrc/attention_bthd_bwd.cu",
            "replaces": source_line,
            "launches": sum(launches_by_path.values()),
            "launches_by_path": launches_by_path,
            "max_abs_err": bwd_bthd_worst[kind],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    rows = {"attention_packed_fwd": 1, "attention_packed_bwd": 2, "sinkhorn_log": 9,
            "attention_bthd_fwd": 7, "attention_bhtc_fwd": 3, "attention_bthd_bwd": 8,
            "attention_bhtc_bwd": 4}
    for kernel in kernels:
        row = rows[kernel["name"]]
        kernel["launches_by_path"].update(ffhq128_fused_serve=fused_serve_others[row],
                                          ffhq128_fused_train=fused_stats["others"][row])
    for kind, source, line, worst_kind, timing, by_path in (
            ("fwd", "attention_block.cu", 443, "fwd", block_timings[("fwd", 1024, 2)],
             {"ffhq128_fused_serve": fused_launches,
              "ffhq128_fused_train": fused_train["forward"]}),
            ("bwd", "attention_block_bwd.cu", 481, "bwd", block_timings[("bwd", 1024, 2)],
             {"ffhq128_fused_serve": fused_serve_others[6],
              "ffhq128_fused_train": fused_train["backward"]})):
        kernels.append({
            "name": f"attention_block_{kind}",
            "route": "cuda",
            "source": f"ot_vae_tpu_torch/ops/csrc/{source}",
            "replaces": f"ot_vae_tpu/ops/attention_pallas.py:{line}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": block_worst[worst_kind],
            "ms": timing["ms"],
            "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": timing["library_ms"],
        })
    for kernel in kernels:
        _with_shares(kernel)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
