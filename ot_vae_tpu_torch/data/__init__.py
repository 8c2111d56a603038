from ot_vae_tpu_torch.data.base import ArrayDataset, BaseDatamodule, dataset_split
from ot_vae_tpu_torch.data.datasets import CIFAR10, FFHQ128, MNIST, MNIST32, ImageFolderData
from ot_vae_tpu_torch.data.synthetic import synthetic_digits, synthetic_textures
from ot_vae_tpu_torch.data.transforms import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    FFHQ128_MEAN,
    FFHQ128_STD,
    CenterCrop,
    Compose,
    GaussianBlur,
    Identity,
    Normalize,
    Pad,
    RandomHorizontalFlip,
    Transform,
    UnNormalize,
    cifar10_transforms,
    ffhq128_transforms,
    from_spec,
    to_spec,
)

__all__ = ["Transform", "Identity", "Compose", "Normalize", "UnNormalize", "Pad",
           "CenterCrop", "GaussianBlur", "RandomHorizontalFlip", "FFHQ128_MEAN",
           "FFHQ128_STD", "CIFAR10_MEAN", "CIFAR10_STD", "ffhq128_transforms",
           "cifar10_transforms", "to_spec", "from_spec", "ArrayDataset", "BaseDatamodule",
           "dataset_split", "synthetic_digits", "synthetic_textures", "ImageFolderData",
           "FFHQ128", "MNIST", "MNIST32", "CIFAR10"]
