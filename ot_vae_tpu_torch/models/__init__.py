from ot_vae_tpu_torch.models.base import VisionModel
from ot_vae_tpu_torch.models.vae import VAE, VAENet

__all__ = ["VisionModel", "VAE", "VAENet"]
