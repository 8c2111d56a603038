from ot_vae_tpu_torch.networks.cnn import (
    CNN,
    AttentionBlock,
    AutoEncoder,
    ConvBlock,
    Conv1x1,
    ConvLayer,
)

__all__ = ["CNN", "AutoEncoder", "AttentionBlock", "ConvBlock", "ConvLayer", "Conv1x1"]
