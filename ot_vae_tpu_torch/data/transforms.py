"""Transforms on NHWC tensors or numpy arrays
(counterpart: ``ot_vae_tpu/data/transforms.py``), their JSON specs for the
checkpoint sidecar, and the FFHQ128 normalisation constants
(``ot_vae_tpu/data/datasets.py``, class ``FFHQ128``)."""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["Transform", "Identity", "Compose", "Normalize", "UnNormalize",
           "FFHQ128_MEAN", "FFHQ128_STD", "ffhq128_transforms", "to_spec", "from_spec"]

FFHQ128_MEAN: Tuple[float, ...] = (0.5207, 0.4254, 0.3805)
FFHQ128_STD: Tuple[float, ...] = (0.1164, 0.1110, 0.1162)


def _constants(x, *values):
    """Per-channel constants in x's dtype, as numpy arrays or as tensors on
    x's device."""
    if isinstance(x, np.ndarray):
        return tuple(np.asarray(v, dtype=x.dtype) for v in values)
    return tuple(torch.tensor(v, dtype=x.dtype, device=x.device) for v in values)


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
        mean, std = _constants(x, self.mean, self.std)
        return (x - mean) / std


@dataclasses.dataclass(frozen=True)
class UnNormalize(Transform):
    """x * std + mean, the inverse of :class:`Normalize`."""

    mean: Tuple[float, ...]
    std: Tuple[float, ...]

    def __call__(self, x):
        mean, std = _constants(x, self.mean, self.std)
        return x * std + mean


def ffhq128_transforms() -> Tuple[Normalize, UnNormalize]:
    """The FFHQ128 (pre, post) inference transforms."""
    return Normalize(FFHQ128_MEAN, FFHQ128_STD), UnNormalize(FFHQ128_MEAN, FFHQ128_STD)


_REGISTRY = {cls.__name__: cls for cls in (Identity, Normalize, UnNormalize)}


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
