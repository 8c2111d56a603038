"""Seeded synthetic images (counterpart: ``ot_vae_tpu/data/synthetic.py``).

Where the real image folders are absent, ``ImageFolderData`` falls back to
these textures when its ``synthetic_train``/``synthetic_test`` are set; the
numpy draws are those of the JAX package, so both see the same images.
"""
from __future__ import annotations

import numpy as np

__all__ = ["synthetic_textures"]


def synthetic_textures(n: int, seed: int = 0, size: int = 32, channels: int = 3,
                       num_classes: int = 10):
    """Class-dependent oriented sinusoidal textures on coloured backgrounds:
    images [n, size, size, C] in [0, 1], labels [n]."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n)
    yy, xx = np.mgrid[0:size, 0:size] / size
    images = np.empty((n, size, size, channels), dtype=np.float32)
    for i, lab in enumerate(labels):
        theta = np.pi * lab / num_classes + rng.normal(0, 0.08)
        # low spatial frequencies, as natural images have
        freq = 1.0 + (lab % 5) * 0.4 + rng.normal(0, 0.1)
        phase = rng.uniform(0, 2 * np.pi)
        wave = 0.5 + 0.5 * np.sin(
            2 * np.pi * freq * (np.cos(theta) * xx + np.sin(theta) * yy) + phase)
        base = rng.uniform(0.15, 0.85, channels).astype(np.float32)
        img = wave[..., None] * base + (1 - wave[..., None]) * (1 - base) * 0.5
        img += rng.normal(0, 0.01, img.shape)
        images[i] = np.clip(img, 0.0, 1.0)
    return images, labels.astype(np.int32)
