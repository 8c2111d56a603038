"""Value checks and sanitizers for the OT core's inputs (counterpart:
``ot_vae_tpu/ops/validate.py``): findings are returned as tensors, never
raised or warned from inside the computation, and the ``sanitize_*``
functions apply their corrections unconditionally."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ot_vae_tpu_torch.ops.matrix import (
    STABILITY_CONST,
    is_pd,
    is_symmetric,
    make_psd,
    min_eig,
    symmetrize,
)

__all__ = ["Diagnostics", "check_spd", "check_prob", "sanitize_spd", "sanitize_prob"]


class Diagnostics(NamedTuple):
    """What a batch of matrices expected to be SPD showed."""

    all_symmetric: torch.Tensor  # bool
    all_pd: torch.Tensor  # bool
    min_eigenvalue: torch.Tensor
    max_correction: torch.Tensor  # the diagonal shift sanitize_spd applies


def check_spd(matrices: torch.Tensor, strict: bool = True) -> Diagnostics:
    """Symmetry, positive-definiteness and the smallest eigenvalue of a
    batch expected to be SPD."""
    me = min_eig(symmetrize(matrices)).amin()
    return Diagnostics(
        all_symmetric=torch.all(is_symmetric(matrices)),
        all_pd=torch.all(is_pd(matrices, strict=strict)),
        min_eigenvalue=me,
        max_correction=torch.abs(torch.clamp_max(me, 0.0)))


def sanitize_spd(matrices: torch.Tensor,
                 strict: bool = True) -> Tuple[torch.Tensor, Diagnostics]:
    """Symmetrize and shift to SPD, with the diagnostics of the input."""
    return make_psd(symmetrize(matrices), strict=strict), check_spd(matrices, strict)


def check_prob(p: torch.Tensor, tol: float = 1e-5) -> torch.Tensor:
    """True where a vector is non-negative (to ``tol``) and sums to 1."""
    nonneg = torch.all(p >= -tol, dim=-1)
    return nonneg & (torch.abs(p.sum(-1) - 1.0) <= tol)


def sanitize_prob(p: torch.Tensor) -> torch.Tensor:
    """Clip to non-negative and renormalize."""
    p = torch.clamp_min(p, 0.0)
    return p / torch.clamp_min(p.sum(-1, keepdim=True), STABILITY_CONST)
