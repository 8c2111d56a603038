"""Transforms on NHWC tensors or numpy arrays
(counterpart: ``ot_vae_tpu/data/transforms.py``), their JSON specs for the
checkpoint sidecar, and the FFHQ128 and CIFAR10 normalisation constants
(``ot_vae_tpu/data/datasets.py``, classes ``FFHQ128`` and ``CIFAR10``).

A transform is called as ``t(x, generator=None)``: the JAX package's take
``(x, key)``; the port's take a ``torch.Generator`` where they draw."""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Transform", "Identity", "Compose", "Normalize", "UnNormalize", "Pad",
           "CenterCrop", "GaussianBlur", "RandomHorizontalFlip", "FFHQ128_MEAN", "FFHQ128_STD",
           "CIFAR10_MEAN", "CIFAR10_STD", "ffhq128_transforms", "cifar10_transforms",
           "to_spec", "from_spec"]

FFHQ128_MEAN: Tuple[float, ...] = (0.5207, 0.4254, 0.3805)
FFHQ128_STD: Tuple[float, ...] = (0.1164, 0.1110, 0.1162)
CIFAR10_MEAN: Tuple[float, ...] = (0.4914, 0.4822, 0.4465)
CIFAR10_STD: Tuple[float, ...] = (0.247, 0.243, 0.261)


def _constants(x, *values):
    """Per-channel constants in x's dtype, as numpy arrays or as tensors on
    x's device."""
    if isinstance(x, np.ndarray):
        return tuple(np.asarray(v, dtype=x.dtype) for v in values)
    return tuple(torch.tensor(v, dtype=x.dtype, device=x.device) for v in values)


@dataclasses.dataclass(frozen=True)
class Transform:
    def __call__(self, x, generator=None):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Identity(Transform):
    def __call__(self, x, generator=None):
        return x


@dataclasses.dataclass(frozen=True)
class Compose(Transform):
    transforms: Tuple[Transform, ...]

    def __init__(self, transforms: Sequence[Transform]):
        object.__setattr__(self, "transforms", tuple(transforms))

    def __call__(self, x, generator=None):
        for t in self.transforms:
            x = t(x, generator)
        return x


@dataclasses.dataclass(frozen=True)
class Normalize(Transform):
    """(x - mean) / std per channel (channels-last)."""

    mean: Tuple[float, ...]
    std: Tuple[float, ...]

    def __call__(self, x, generator=None):
        mean, std = _constants(x, self.mean, self.std)
        return (x - mean) / std


@dataclasses.dataclass(frozen=True)
class UnNormalize(Transform):
    """x * std + mean, the inverse of :class:`Normalize`."""

    mean: Tuple[float, ...]
    std: Tuple[float, ...]

    def __call__(self, x, generator=None):
        mean, std = _constants(x, self.mean, self.std)
        return x * std + mean


@dataclasses.dataclass(frozen=True)
class Pad(Transform):
    """Zero-pad H and W by ``padding`` on each side (torchvision T.Pad)."""

    padding: int

    def __call__(self, x, generator=None):
        p = self.padding
        if isinstance(x, np.ndarray):
            return np.pad(x, [(0, 0)] * (x.ndim - 3) + [(p, p), (p, p), (0, 0)])
        return F.pad(x, (0, 0, p, p, p, p))


@dataclasses.dataclass(frozen=True)
class CenterCrop(Transform):
    """Center-crop H and W to ``size`` (torchvision T.CenterCrop)."""

    size: int

    def __call__(self, x, generator=None):
        h, w = x.shape[-3], x.shape[-2]
        top, left = (h - self.size) // 2, (w - self.size) // 2
        return x[..., top:top + self.size, left:left + self.size, :]


@dataclasses.dataclass(frozen=True)
class GaussianBlur(Transform):
    """Depthwise Gaussian blur with a fixed sigma (torchvision T.GaussianBlur),
    the degradation of the latent-transport experiments. Runs on the input's
    device; draws nothing, so ``generator`` is unused."""

    kernel_size: int
    sigma: float

    def _kernel(self) -> np.ndarray:
        k = self.kernel_size
        ax = np.arange(k) - (k - 1) / 2.0
        g = np.exp(-0.5 * (ax / self.sigma) ** 2)
        g /= g.sum()
        return np.outer(g, g).astype(np.float32)

    def __call__(self, x, generator=None):
        as_numpy = isinstance(x, np.ndarray)
        t = torch.from_numpy(x) if as_numpy else x
        squeeze = t.dim() == 3
        if squeeze:
            t = t[None]
        c = t.shape[-1]
        k = self.kernel_size
        weight = torch.from_numpy(self._kernel()).to(t.device, t.dtype)
        weight = weight.expand(c, 1, k, k)
        pad = (k - 1) // 2
        nchw = F.pad(t.permute(0, 3, 1, 2), (pad, k - 1 - pad, pad, k - 1 - pad))
        out = F.conv2d(nchw, weight, groups=c).permute(0, 2, 3, 1)
        out = out[0] if squeeze else out
        return out.contiguous().numpy() if as_numpy else out.contiguous()


def ffhq128_transforms() -> Tuple[Normalize, UnNormalize]:
    """The FFHQ128 (pre, post) inference transforms."""
    return Normalize(FFHQ128_MEAN, FFHQ128_STD), UnNormalize(FFHQ128_MEAN, FFHQ128_STD)


def cifar10_transforms() -> Tuple[Normalize, UnNormalize]:
    """The CIFAR10 (pre, post) inference transforms."""
    return Normalize(CIFAR10_MEAN, CIFAR10_STD), UnNormalize(CIFAR10_MEAN, CIFAR10_STD)


@dataclasses.dataclass(frozen=True)
class RandomHorizontalFlip(Transform):
    """Flip W with probability p, per batch element of an NHWC batch (the
    whole image when unbatched): CIFAR10's training augmentation
    (counterpart: ``ot_vae_tpu/data/transforms.py:122-139``). The flips are
    drawn from ``generator``, a ``torch.Generator`` on x's device (on the
    CPU for numpy arrays); the JAX host path draws them from numpy's global,
    unseeded generator instead.

    :raises ValueError: without a generator
    """

    p: float = 0.5

    def __call__(self, x, generator=None):
        if generator is None:
            raise ValueError("RandomHorizontalFlip needs a generator")
        batched = x.ndim == 4
        as_numpy = isinstance(x, np.ndarray)
        flip = torch.rand(x.shape[0] if batched else 1, generator=generator,
                          device="cpu" if as_numpy else x.device) < self.p
        flip = flip.reshape((-1, 1, 1, 1) if batched else ())
        if as_numpy:
            return np.where(flip.numpy(), x[..., ::-1, :], x)
        return torch.where(flip, x.flip(-2), x)


_REGISTRY = {cls.__name__: cls for cls in (Identity, Normalize, UnNormalize, Pad,
                                            CenterCrop, GaussianBlur, RandomHorizontalFlip)}


def to_spec(t: Transform) -> dict:
    """A JSON-able spec of a transform (tree), the format of the JAX
    package's sidecar: ``{"kind": class name, **fields}``."""
    if isinstance(t, Compose):
        return {"kind": "Compose", "transforms": [to_spec(s) for s in t.transforms]}
    if type(t).__name__ not in _REGISTRY:
        raise ValueError(f"no spec for transform {type(t).__name__}")
    spec = {"kind": type(t).__name__}
    spec.update({f.name: getattr(t, f.name) for f in dataclasses.fields(t)})
    return spec


def from_spec(spec: dict) -> Transform:
    spec = dict(spec)
    kind = spec.pop("kind")
    if kind == "Compose":
        return Compose([from_spec(s) for s in spec["transforms"]])
    if kind not in _REGISTRY:
        raise ValueError(f"transform {kind!r} is not ported")
    # JSON round-trips tuples as lists
    return _REGISTRY[kind](**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in spec.items()})
