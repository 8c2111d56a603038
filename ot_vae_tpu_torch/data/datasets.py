"""Image-folder datamodules (counterpart: ``ImageFolderData`` and
``FFHQ128`` in ``ot_vae_tpu/data/datasets.py``).

Images are read from a folder with PIL, which is imported only when a
folder holds images. With ``synthetic_train``/``synthetic_test`` set, a
missing folder falls back to the seeded :func:`synthetic_textures` at the
module's resolution, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Tuple

import numpy as np

from ot_vae_tpu_torch.data.base import ArrayDataset, BaseDatamodule, dataset_split
from ot_vae_tpu_torch.data.synthetic import synthetic_textures
from ot_vae_tpu_torch.data.transforms import (
    FFHQ128_MEAN,
    FFHQ128_STD,
    Normalize,
    UnNormalize,
)

__all__ = ["ImageFolderData", "FFHQ128"]


@dataclasses.dataclass
class ImageFolderData(BaseDatamodule):
    """Folder-of-images datamodule; images are resized to ``size`` and
    normalised with (MEAN, STD). ``root`` is (train folder, test folder);
    the validation split is the ``test_val_split`` share of the test folder
    (the rest is the JAX package's test split, which no loop reads yet).
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
        (vi, vl), _ = dataset_split(*test, self.test_val_split, self.seed)
        self.val_dataset = ArrayDataset(vi, vl, self._transform)


@dataclasses.dataclass
class FFHQ128(ImageFolderData):
    size: int = 128
    MEAN: Tuple[float, ...] = FFHQ128_MEAN
    STD: Tuple[float, ...] = FFHQ128_STD
    root: Tuple[str, str] = ("~/data/ffhq_128_train", "~/data/ffhq_128_test")
