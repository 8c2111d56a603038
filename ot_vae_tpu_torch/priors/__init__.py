from ot_vae_tpu_torch.priors.base import PriorModule
from ot_vae_tpu_torch.priors.codebook import CodebookPrior
from ot_vae_tpu_torch.priors.conditional_gaussian import ConditionalGaussianPrior
from ot_vae_tpu_torch.priors.gaussian import GaussianPrior

__all__ = ["PriorModule", "GaussianPrior", "ConditionalGaussianPrior", "CodebookPrior"]
