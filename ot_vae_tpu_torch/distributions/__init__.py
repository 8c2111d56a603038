"""Distribution models fitted online (counterpart: ``ot_vae_tpu/distributions``):
the Gaussian, the Gaussian mixture and the codebook."""
from ot_vae_tpu_torch.distributions.codebook import (
    Assignment,
    CodebookModel,
    CodebookState,
    assign_from_energy,
    kmeanspp_init,
)
from ot_vae_tpu_torch.distributions.gaussian import GaussianModel, GaussianParams, GaussianState
from ot_vae_tpu_torch.distributions.gmm import GMMModel, GMMParams, GMMState

__all__ = ["Assignment", "CodebookModel", "CodebookState", "assign_from_energy",
           "kmeanspp_init", "GaussianModel", "GaussianParams", "GaussianState",
           "GMMModel", "GMMParams", "GMMState"]
