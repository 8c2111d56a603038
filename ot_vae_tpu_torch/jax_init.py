"""The JAX package's initial weights of a seed, drawn without JAX.

A numpy copy of JAX's default PRNG (threefry-2x32 with partitionable splits:
``PRNGKey``, ``fold_in``, ``split``, and the f32 ``uniform``, ``normal`` and
``truncated_normal`` draws) and of flax's parameter keys: a parameter's key
is its scope path and its count within the scope, SHA-1 hashed and folded
into the root key. :func:`load_jax_trainer_init` puts into a port net the
weights that the JAX package's ``Trainer(seed=s)`` initialises the same net
with. They agree to a few f32 ulps: the inverse error function is torch's in
f64, XLA's a polynomial in f32.
"""
from __future__ import annotations

import hashlib
import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ot_vae_tpu_torch.convert import jax_variables_to_state_dict, state_dict_to_jax_variables
from ot_vae_tpu_torch.networks import nets_utils

__all__ = ["prng_key", "fold_in", "split", "uniform", "normal", "truncated_normal",
           "load_jax_trainer_init"]

Key = Tuple[np.uint32, np.uint32]
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNCATED_STD = np.float32(0.87962566103423978)


def _threefry2x32(key: Key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds of (key, (x0, x1)), elementwise."""
    ks = (np.uint32(key[0]), np.uint32(key[1]),
          np.uint32(key[0]) ^ np.uint32(key[1]) ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _counters(n: int):
    return np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32)


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for 0 ≤ seed < 2³²."""
    return np.uint32(0), np.uint32(seed)


def fold_in(key: Key, data: int) -> Key:
    y0, y1 = _threefry2x32(key, np.zeros(1, np.uint32), np.array([data], np.uint32))
    return y0[0], y1[0]


def split(key: Key, num: int):
    return list(zip(*_threefry2x32(key, *_counters(num))))


def _fold_in_path(key: Key, path) -> Key:
    """flax's ``LazyRng``: the strings and ints of ``path`` SHA-1 hashed,
    the first 4 bytes folded in."""
    digest = hashlib.sha1()
    for x in path:
        digest.update(x.encode() if isinstance(x, str)
                      else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(digest.digest()[:4], "big"))


def uniform(key: Key, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """f32 ``jax.random.uniform``: 23 random mantissa bits of a float in
    [1, 2), shifted and scaled."""
    y0, y1 = _threefry2x32(key, *_counters(math.prod(shape)))
    bits = ((y0 ^ y1) >> np.uint32(9)) | np.uint32(0x3F800000)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, (bits.view(np.float32) - np.float32(1.0)) * (hi - lo) + lo
                      ).reshape(shape)


def _erfinv(u: np.ndarray) -> np.ndarray:
    return torch.special.erfinv(torch.from_numpy(u.astype(np.float64))).numpy().astype(
        np.float32)


def normal(key: Key, shape) -> np.ndarray:
    """f32 ``jax.random.normal``: √2·erfinv(u), u uniform in (−1, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return np.float32(math.sqrt(2)) * _erfinv(uniform(key, shape, lo, 1.0))


def truncated_normal(key: Key, shape, lower: float = -2.0, upper: float = 2.0) -> np.ndarray:
    """f32 ``jax.random.truncated_normal``: √2·erfinv(u), u uniform in
    (erf(lower/√2), erf(upper/√2)), clipped inside (lower, upper)."""
    sqrt2 = np.float32(math.sqrt(2))
    a = np.float32(math.erf(np.float32(lower) / sqrt2))
    b = np.float32(math.erf(np.float32(upper) / sqrt2))
    out = sqrt2 * _erfinv(uniform(key, shape, a, b))
    return np.clip(out, np.nextafter(np.float32(lower), np.float32(np.inf)),
                   np.nextafter(np.float32(upper), np.float32(-np.inf)))


def _lecun_normal(key: Key, shape, fan_in: int) -> np.ndarray:
    std = np.sqrt(np.float32(1.0 / fan_in)) / _TRUNCATED_STD
    return truncated_normal(key, shape) * std


def _draw(module: nn.Module, leaf: str, key: Key, shape):
    """The flax initializer's draw for ``leaf`` of the port module
    ``module`` (JAX layout ``shape``), or None for a leaf that flax fills
    with a constant."""
    if isinstance(module, (nets_utils._ConvParams, nets_utils.Dense)) and leaf == "kernel":
        return _lecun_normal(key, shape, math.prod(shape[:-1]))
    if isinstance(module, nets_utils.EqualDense) and leaf == "kernel":
        return normal(key, shape) * np.float32(1.0 / module.lr_mult)
    if isinstance(module, nets_utils.EqualConv) and leaf == "kernel":
        return normal(key, shape) * np.float32(1.0 / module.equalized_lr)
    if isinstance(module, nets_utils.GaussianFourierProjection) and leaf == "weight":
        return normal(key, shape) * np.float32(module.scale)
    if isinstance(module, nets_utils.Embed) and leaf == "embedding":
        return normal(key, shape) * np.sqrt(np.float32(1.0 / shape[-1]))
    return None


@torch.no_grad()
def load_jax_trainer_init(net: nn.Module, seed: int) -> nn.Module:
    """Loads into ``net`` (a VAE's net, in place) the initial weights that
    the JAX package's ``Trainer(seed=seed)`` draws for the same net:
    ``VAE.init_variables`` takes ``fold_in(PRNGKey(seed), 0)``, splits it in
    3 and draws the parameters from the first. Covers the CNN nets (flax's
    Conv and Dense kernels, ``EqualDense``, ``EqualConv``, the Gaussian
    Fourier projection, ``Embed``); every other leaf must be a constant.

    :raises NotImplementedError: for a random leaf of another module
    """
    variables = state_dict_to_jax_variables(net.state_dict())
    root = split(fold_in(prng_key(seed), 0), 3)[0]

    def walk(tree, path):
        for leaf, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + (leaf,))
                continue
            module = net.get_submodule(".".join(path))
            # each of these leaves is its scope's first parameter: count 1
            drawn = _draw(module, leaf, _fold_in_path(root, path + (1,)), tuple(value.shape))
            if drawn is not None:
                tree[leaf] = drawn
            elif np.unique(np.asarray(value)).size > 1:
                raise NotImplementedError(
                    f"{'/'.join(path + (leaf,))}: no JAX initializer for {type(module).__name__}")

    walk(variables["params"], ())
    net.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return net
