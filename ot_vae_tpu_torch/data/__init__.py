from ot_vae_tpu_torch.data.transforms import (
    FFHQ128_MEAN,
    FFHQ128_STD,
    Compose,
    Identity,
    Normalize,
    Transform,
    UnNormalize,
    ffhq128_transforms,
)

__all__ = ["Transform", "Identity", "Compose", "Normalize", "UnNormalize",
           "FFHQ128_MEAN", "FFHQ128_STD", "ffhq128_transforms"]
