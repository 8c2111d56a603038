"""Datamodule protocol and the numpy batching path
(counterpart: ``ot_vae_tpu/data/base.py``).

A datamodule owns per-split arrays, transforms and batch sizes and yields
numpy NHWC batches ``(images, labels)``. Batches have a fixed shape (the
ragged last batch is dropped) and the training split is shuffled with
``default_rng(seed + epoch)``, so the batches equal the JAX package's one
for one. A transform that draws (CIFAR10's random flip) draws from a
``torch.Generator`` seeded from (seed, epoch), where the JAX package's host
path draws from numpy's global, unseeded generator. The C++ prefetching
batcher of the JAX package is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ot_vae_tpu_torch.data.transforms import Identity, Transform

__all__ = ["ArrayDataset", "BaseDatamodule", "dataset_split"]


@dataclasses.dataclass
class ArrayDataset:
    """In-memory dataset: images [N, H, W, C] float32 + labels [N] int32."""

    images: np.ndarray
    labels: np.ndarray
    transform: Transform = Identity()

    def __len__(self) -> int:
        return len(self.images)

    def batches(self, batch_size: int, shuffle: bool, seed: Optional[int],
                epoch: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.images)
        idx = np.arange(n)
        if shuffle:
            rng = np.random.default_rng(None if seed is None else seed + epoch)
            rng.shuffle(idx)
        draws = torch.Generator()
        if seed is None:
            draws.seed()
        else:
            state = np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)[0]
            draws.manual_seed(int(state >> 1))
        for start in range(0, n - batch_size + 1, batch_size):
            sel = idx[start:start + batch_size]
            yield (np.asarray(self.transform(self.images[sel], draws), np.float32),
                   self.labels[sel])


def dataset_split(images: np.ndarray, labels: np.ndarray, split: float,
                  seed: Optional[int] = None):
    """Seeded non-overlapping split: (first ``split`` share, the rest)."""
    if not 0.0 <= split <= 1.0:
        raise ValueError(f"split must be in [0, 1], got {split}")
    n = len(images)
    size = int(n * split)
    idx = np.random.default_rng(seed).permutation(n)
    a, b = idx[:size], idx[size:]
    return (images[a], labels[a]), (images[b], labels[b])


@dataclasses.dataclass
class BaseDatamodule:
    """Per-split datasets (train, val, test, predict), transforms and batch
    sizes."""

    train_batch_size: int = 32
    val_batch_size: int = 256
    test_batch_size: int = 256
    predict_batch_size: int = 256
    seed: Optional[int] = None
    img_size: Optional[Tuple[int, int]] = None
    inference_preprocess: Transform = Identity()
    inference_postprocess: Transform = Identity()

    train_dataset: Optional[ArrayDataset] = None
    val_dataset: Optional[ArrayDataset] = None
    test_dataset: Optional[ArrayDataset] = None
    predict_dataset: Optional[ArrayDataset] = None

    def setup(self) -> None:
        """Materialise the datasets; subclasses override."""

    def _dataset(self, mode: str) -> ArrayDataset:
        ds = getattr(self, f"{mode}_dataset")
        if ds is None:
            self.setup()
            ds = getattr(self, f"{mode}_dataset")
        if ds is None:
            raise ValueError(f"no {mode} dataset")
        return ds

    def _loader(self, mode: str, epoch: int = 0):
        ds = self._dataset(mode)
        bs = getattr(self, f"{mode}_batch_size")
        return ds.batches(min(bs, len(ds)), mode == "train", self.seed, epoch)

    def train_batches(self, epoch: int = 0):
        return self._loader("train", epoch)

    def val_batches(self):
        return self._loader("val")

    def test_batches(self):
        return self._loader("test")

    def predict_batches(self):
        return self._loader("predict")

    def steps_per_epoch(self, mode: str = "train") -> int:
        ds = self._dataset(mode)
        bs = getattr(self, f"{mode}_batch_size")
        return len(ds) // min(bs, len(ds))
