"""Seeded synthetic images (counterpart: ``ot_vae_tpu/data/synthetic.py``).

Where the real data is absent, ``MNIST`` falls back to the digits and
``ImageFolderData`` to the textures (when its ``synthetic_train`` and
``synthetic_test`` are set); the numpy draws are those of the JAX package,
so both see the same images.
"""
from __future__ import annotations

import numpy as np

__all__ = ["synthetic_digits", "synthetic_textures"]

# 5×7 bitmap glyphs for digits 0-9 (rows, 1 = ink)
_GLYPHS = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11110", "00001", "00001", "01110", "00001", "00001", "11110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _render_digit(digit: int, rng: np.random.Generator, size: int = 28) -> np.ndarray:
    """Rasterise a digit glyph with random scale, offset and intensity."""
    glyph = np.array([[float(c) for c in row] for row in _GLYPHS[digit]], dtype=np.float32)
    scale = rng.uniform(2.2, 3.4)
    h, w = int(7 * scale), int(5 * scale)
    ys = np.clip((np.arange(h) / scale).astype(int), 0, 6)  # nearest upsampling
    xs = np.clip((np.arange(w) / scale).astype(int), 0, 4)
    big = glyph[np.ix_(ys, xs)]
    img = np.zeros((size, size), dtype=np.float32)
    max_top, max_left = size - h, size - w
    top = int(rng.integers(max(1, max_top // 2 - 3), min(max_top, max_top // 2 + 4)))
    left = int(rng.integers(max(1, max_left // 2 - 3), min(max_left, max_left // 2 + 4)))
    img[top:top + h, left:left + w] = big
    # soften the strokes as real MNIST's are: a separable box blur, twice
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)) / 3.0
        img = (img + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 3.0
    img *= rng.uniform(0.85, 1.0) / max(img.max(), 1e-6)
    img += rng.normal(0.0, 0.01, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def synthetic_digits(n: int, seed: int = 0, size: int = 28):
    """MNIST-like digits: images [n, size, size, 1] in [0, 1], labels [n]."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    images = np.stack([_render_digit(int(d), rng, size) for d in labels])
    return images[..., None].astype(np.float32), labels.astype(np.int32)


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
