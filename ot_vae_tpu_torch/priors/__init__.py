from ot_vae_tpu_torch.priors.base import PriorModule
from ot_vae_tpu_torch.priors.gaussian import GaussianPrior

__all__ = ["PriorModule", "GaussianPrior"]
