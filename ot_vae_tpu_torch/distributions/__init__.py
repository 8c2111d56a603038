"""Distribution models fitted online (counterpart: ``ot_vae_tpu/distributions``).
Slice 3 carries the codebook; the Gaussian and GMM models follow with the OT
core (ROADMAP)."""
from ot_vae_tpu_torch.distributions.codebook import (
    Assignment,
    CodebookModel,
    CodebookState,
    assign_from_energy,
    kmeanspp_init,
)

__all__ = ["Assignment", "CodebookModel", "CodebookState", "assign_from_energy",
           "kmeanspp_init"]
