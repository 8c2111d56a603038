from ot_vae_tpu_torch.networks.cnn import CNN, AttentionBlock, ConvBlock, ConvLayer, Conv1x1

__all__ = ["CNN", "AttentionBlock", "ConvBlock", "ConvLayer", "Conv1x1"]
