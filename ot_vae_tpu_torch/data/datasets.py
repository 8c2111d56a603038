"""Named datamodules (counterpart: ``MNIST``, ``MNIST32``, ``CIFAR10``,
``ImageFolderData`` and ``FFHQ128`` in ``ot_vae_tpu/data/datasets.py``).

MNIST is read from its idx files in the local cache (``$OT_VAE_DATA_CACHE``
or ``~/.cache``, under ``MNIST/raw``) when they are there, else the seeded
:func:`synthetic_digits` stand in; CIFAR10 likewise from the python batches
under ``cifar-10-batches-py``, else the seeded :func:`synthetic_textures`;
nothing is downloaded. Image folders are
read with PIL, which is imported only when a folder holds images; with
``synthetic_train``/``synthetic_test`` set, a missing folder falls back to
the seeded :func:`synthetic_textures` at the module's resolution, as in the
JAX package.
"""
from __future__ import annotations

import dataclasses
import gzip
import os
import pickle
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ot_vae_tpu_torch.data.base import ArrayDataset, BaseDatamodule, dataset_split
from ot_vae_tpu_torch.data.synthetic import synthetic_digits, synthetic_textures
from ot_vae_tpu_torch.data.transforms import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    FFHQ128_MEAN,
    FFHQ128_STD,
    CenterCrop,
    Compose,
    Identity,
    Normalize,
    Pad,
    RandomHorizontalFlip,
    UnNormalize,
)

__all__ = ["MNIST", "MNIST32", "CIFAR10", "ImageFolderData", "FFHQ128"]


def _cache_dir() -> Path:
    """Dataset cache root: ``$OT_VAE_DATA_CACHE`` or ``~/.cache``, read at
    each setup."""
    return Path(os.environ.get("OT_VAE_DATA_CACHE", os.path.expanduser("~/.cache")))


def _load_idx(path: Path) -> Optional[np.ndarray]:
    """An (optionally gzipped) idx file, MNIST's format; None when unreadable."""
    opener = gzip.open if path.suffix == ".gz" else open
    try:
        with opener(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    ndim = int.from_bytes(data[0:4], "big") & 0xFF
    dims = [int.from_bytes(data[4 + 4 * i:8 + 4 * i], "big") for i in range(ndim)]
    return np.frombuffer(data, np.uint8, offset=4 + 4 * ndim).reshape(dims)


def _load_mnist_raw(train: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    base = _cache_dir() / "MNIST" / "raw"
    prefix = "train" if train else "t10k"
    for suffix in ("", ".gz"):
        imgs = _load_idx(base / f"{prefix}-images-idx3-ubyte{suffix}")
        labs = _load_idx(base / f"{prefix}-labels-idx1-ubyte{suffix}")
        if imgs is not None and labs is not None:
            return imgs.astype(np.float32)[..., None] / 255.0, labs.astype(np.int32)
    return None


class _ArrayUnpickler(pickle.Unpickler):
    """Reads CIFAR10's python batches: dicts of bytes, lists and numpy
    arrays, and no other global."""

    _ALLOWED = {("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "_reconstruct"),
                ("numpy", "ndarray"), ("numpy", "dtype")}

    def find_class(self, module, name):
        if (module, name) not in self._ALLOWED:
            raise pickle.UnpicklingError(f"{module}.{name} is not allowed in a CIFAR10 batch")
        return super().find_class(module, name)


def _load_cifar10_raw(train: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    base = _cache_dir() / "cifar-10-batches-py"
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    imgs, labs = [], []
    for name in names:
        path = base / name
        if not path.exists():
            return None
        with open(path, "rb") as f:
            d = _ArrayUnpickler(f, encoding="bytes").load()
        imgs.append(np.asarray(d[b"data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labs.extend(d[b"labels"])
    return np.concatenate(imgs).astype(np.float32) / 255.0, np.asarray(labs, np.int32)


@dataclasses.dataclass
class MNIST(BaseDatamodule):
    """28×28 grey digits normalised with MNIST's mean and std; ``pad`` zero-
    pads them after normalising (and the inference post-transform crops
    back). The validation split is the ``test_val_split`` share of the test
    set, the test split the rest; predict reads the whole test set raw."""

    MEAN: Tuple[float, ...] = (0.1307,)
    STD: Tuple[float, ...] = (0.3081,)
    pad: int = 0
    synthetic_train: int = 6000
    synthetic_test: int = 1000
    test_val_split: float = 0.9

    def __post_init__(self):
        norm = [Normalize(self.MEAN, self.STD)]
        denorm = [UnNormalize(self.MEAN, self.STD)]
        if self.pad:
            norm.append(Pad(self.pad))
            denorm.insert(0, CenterCrop(28))
        self.img_size = (28 + 2 * self.pad, 28 + 2 * self.pad)
        self.inference_preprocess = Compose(norm)
        self.inference_postprocess = Compose(denorm)
        self._transform = Compose(norm)

    def setup(self) -> None:
        if self.train_dataset is not None:
            return
        train, test = _load_mnist_raw(True), _load_mnist_raw(False)
        if train is None or test is None:
            train = synthetic_digits(self.synthetic_train, seed=1)
            test = synthetic_digits(self.synthetic_test, seed=2)
        self.train_dataset = ArrayDataset(*train, self._transform)
        (vi, vl), (ti, tl) = dataset_split(*test, self.test_val_split, self.seed)
        self.val_dataset = ArrayDataset(vi, vl, self._transform)
        self.test_dataset = ArrayDataset(ti, tl, self._transform)
        self.predict_dataset = ArrayDataset(*test, Identity())


@dataclasses.dataclass
class MNIST32(MNIST):
    """MNIST padded to 32×32, a power of two for the CNN schedule."""

    pad: int = 2


@dataclasses.dataclass
class CIFAR10(BaseDatamodule):
    """32×32 RGB in 10 classes, normalised with CIFAR10's mean and std. The
    validation split is the ``test_val_split`` share of the test set, the
    test split the rest; predict reads the whole test set raw. The training
    split flips each image with probability 0.5 (``random_flip``), drawn
    from a generator seeded from the datamodule's seed and the epoch."""

    MEAN: Tuple[float, ...] = CIFAR10_MEAN
    STD: Tuple[float, ...] = CIFAR10_STD
    synthetic_train: int = 6000
    synthetic_test: int = 1000
    test_val_split: float = 0.9
    random_flip: bool = True

    def __post_init__(self):
        self.img_size = (32, 32)
        norm = Normalize(self.MEAN, self.STD)
        self.inference_preprocess = norm
        self.inference_postprocess = UnNormalize(self.MEAN, self.STD)
        flip = [RandomHorizontalFlip()] if self.random_flip else []
        self._train_transform = Compose([*flip, norm])
        self._eval_transform = norm

    def setup(self) -> None:
        if self.train_dataset is not None:
            return
        train, test = _load_cifar10_raw(True), _load_cifar10_raw(False)
        if train is None or test is None:
            train = synthetic_textures(self.synthetic_train, seed=1)
            test = synthetic_textures(self.synthetic_test, seed=2)
        self.train_dataset = ArrayDataset(*train, self._train_transform)
        (vi, vl), (ti, tl) = dataset_split(*test, self.test_val_split, self.seed)
        self.val_dataset = ArrayDataset(vi, vl, self._eval_transform)
        self.test_dataset = ArrayDataset(ti, tl, self._eval_transform)
        self.predict_dataset = ArrayDataset(*test, Identity())


@dataclasses.dataclass
class ImageFolderData(BaseDatamodule):
    """Folder-of-images datamodule; images are resized to ``size`` and
    normalised with (MEAN, STD). ``root`` is (train folder, test folder);
    the validation split is the ``test_val_split`` share of the test folder,
    the test split the rest; predict reads the whole test folder raw.
    """

    root: Tuple[str, str] = ("", "")
    size: int = 64
    MEAN: Tuple[float, ...] = (0.5, 0.5, 0.5)
    STD: Tuple[float, ...] = (0.25, 0.25, 0.25)
    test_val_split: float = 0.9
    synthetic_train: int = 0
    synthetic_test: int = 0

    def __post_init__(self):
        self.img_size = (self.size, self.size)
        self.inference_preprocess = Normalize(self.MEAN, self.STD)
        self.inference_postprocess = UnNormalize(self.MEAN, self.STD)
        self._transform = Normalize(self.MEAN, self.STD)

    def _load_folder(self, root: str) -> Tuple[np.ndarray, np.ndarray]:
        folder = Path(os.path.expanduser(str(root)))
        paths = sorted(p for p in folder.rglob("*")
                       if p.suffix.lower() in (".png", ".jpg", ".jpeg", ".bmp"))
        if not paths:
            raise FileNotFoundError(f"no images under {root}")
        from PIL import Image

        classes = sorted({p.parent.name for p in paths})
        cls_idx = {c: i for i, c in enumerate(classes)}
        imgs = np.stack([
            np.asarray(Image.open(p).convert("RGB").resize((self.size, self.size)),
                       np.float32) / 255.0
            for p in paths])
        labels = np.asarray([cls_idx[p.parent.name] for p in paths], np.int32)
        return imgs, labels

    def setup(self) -> None:
        if self.train_dataset is not None:
            return
        try:
            train = self._load_folder(self.root[0])
            test = self._load_folder(self.root[1])
        except FileNotFoundError:
            if not (self.synthetic_train and self.synthetic_test):
                raise
            train = synthetic_textures(self.synthetic_train, seed=1, size=self.size)
            test = synthetic_textures(self.synthetic_test, seed=2, size=self.size)
        self.train_dataset = ArrayDataset(*train, self._transform)
        (vi, vl), (ti, tl) = dataset_split(*test, self.test_val_split, self.seed)
        self.val_dataset = ArrayDataset(vi, vl, self._transform)
        self.test_dataset = ArrayDataset(ti, tl, self._transform)
        self.predict_dataset = ArrayDataset(*test, Identity())


@dataclasses.dataclass
class FFHQ128(ImageFolderData):
    size: int = 128
    MEAN: Tuple[float, ...] = FFHQ128_MEAN
    STD: Tuple[float, ...] = FFHQ128_STD
    root: Tuple[str, str] = ("~/data/ffhq_128_train", "~/data/ffhq_128_test")
