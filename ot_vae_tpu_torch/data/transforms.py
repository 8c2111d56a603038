"""Inference transforms on NHWC tensors
(counterpart: ``ot_vae_tpu/data/transforms.py``), and the FFHQ128
normalisation constants (``ot_vae_tpu/data/datasets.py``, class ``FFHQ128``)."""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

__all__ = ["Transform", "Identity", "Compose", "Normalize", "UnNormalize",
           "FFHQ128_MEAN", "FFHQ128_STD", "ffhq128_transforms"]

FFHQ128_MEAN: Tuple[float, ...] = (0.5207, 0.4254, 0.3805)
FFHQ128_STD: Tuple[float, ...] = (0.1164, 0.1110, 0.1162)


@dataclasses.dataclass(frozen=True)
class Transform:
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Identity(Transform):
    def __call__(self, x):
        return x


@dataclasses.dataclass(frozen=True)
class Compose(Transform):
    transforms: Tuple[Transform, ...]

    def __init__(self, transforms: Sequence[Transform]):
        object.__setattr__(self, "transforms", tuple(transforms))

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


@dataclasses.dataclass(frozen=True)
class Normalize(Transform):
    """(x - mean) / std per channel (channels-last)."""

    mean: Tuple[float, ...]
    std: Tuple[float, ...]

    def __call__(self, x):
        mean = torch.tensor(self.mean, dtype=x.dtype, device=x.device)
        std = torch.tensor(self.std, dtype=x.dtype, device=x.device)
        return (x - mean) / std


@dataclasses.dataclass(frozen=True)
class UnNormalize(Transform):
    """x * std + mean, the inverse of :class:`Normalize`."""

    mean: Tuple[float, ...]
    std: Tuple[float, ...]

    def __call__(self, x):
        mean = torch.tensor(self.mean, dtype=x.dtype, device=x.device)
        std = torch.tensor(self.std, dtype=x.dtype, device=x.device)
        return x * std + mean


def ffhq128_transforms() -> Tuple[Normalize, UnNormalize]:
    """The FFHQ128 (pre, post) inference transforms."""
    return Normalize(FFHQ128_MEAN, FFHQ128_STD), UnNormalize(FFHQ128_MEAN, FFHQ128_STD)
