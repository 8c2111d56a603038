from ot_vae_tpu_torch.networks.cnn import (
    CNN,
    AttentionBlock,
    AutoEncoder,
    ConvBlock,
    Conv1x1,
    ConvLayer,
)
from ot_vae_tpu_torch.networks.nets_utils import EqualDense, GaussianFourierProjection
from ot_vae_tpu_torch.networks.vit import AutoRegressive, ViT

__all__ = ["CNN", "AutoEncoder", "AttentionBlock", "ConvBlock", "ConvLayer", "Conv1x1",
           "EqualDense", "GaussianFourierProjection", "ViT", "AutoRegressive"]
