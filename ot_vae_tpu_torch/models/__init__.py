from ot_vae_tpu_torch.models.auto_diffusion import AutoDiffusion, AutoDiffusionNet
from ot_vae_tpu_torch.models.base import VisionModel
from ot_vae_tpu_torch.models.dad import DAD, DADNet
from ot_vae_tpu_torch.models.vae import VAE, VAENet

__all__ = ["VisionModel", "VAE", "VAENet", "AutoDiffusion", "AutoDiffusionNet", "DAD",
           "DADNet"]
