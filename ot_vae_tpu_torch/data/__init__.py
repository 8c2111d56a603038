from ot_vae_tpu_torch.data.base import ArrayDataset, BaseDatamodule, dataset_split
from ot_vae_tpu_torch.data.datasets import FFHQ128, MNIST, MNIST32, ImageFolderData
from ot_vae_tpu_torch.data.synthetic import synthetic_digits, synthetic_textures
from ot_vae_tpu_torch.data.transforms import (
    FFHQ128_MEAN,
    FFHQ128_STD,
    CenterCrop,
    Compose,
    GaussianBlur,
    Identity,
    Normalize,
    Pad,
    Transform,
    UnNormalize,
    ffhq128_transforms,
    from_spec,
    to_spec,
)

__all__ = ["Transform", "Identity", "Compose", "Normalize", "UnNormalize", "Pad",
           "CenterCrop", "GaussianBlur", "FFHQ128_MEAN", "FFHQ128_STD",
           "ffhq128_transforms", "to_spec", "from_spec", "ArrayDataset", "BaseDatamodule",
           "dataset_split", "synthetic_digits", "synthetic_textures", "ImageFolderData",
           "FFHQ128", "MNIST", "MNIST32"]
