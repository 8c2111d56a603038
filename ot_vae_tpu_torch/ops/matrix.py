"""Batched matrix functions of the OT core in plain PyTorch (counterpart:
``ot_vae_tpu/ops/matrix.py``).

Every function works on a batch [*, D, D] in the input's dtype and device.
The eigendecomposition is ``torch.linalg.eigh`` (cuSOLVER on the card,
LAPACK on the CPU), the counterpart of XLA's eigh; the Newton–Schulz and
polar iterations are matmul-only. ``method="auto"`` means eigh on every
device, as the JAX package resolves it off the TPU.

Products are full f32 whatever ``torch.backends.cuda.matmul.allow_tf32``
says: the iterations amplify TF32's 10-bit mantissa into divergence, and
the Monge operators sandwich ill-conditioned factors (the JAX package runs
them at ``Precision.HIGHEST`` for the same reason). :func:`full_f32` sets
the flag off around each function that multiplies and restores it after.
"""
from __future__ import annotations

import functools
from typing import Tuple, Union

import torch

__all__ = ["STABILITY_CONST", "full_f32", "eye_like", "sqrtm", "invsqrtm",
           "sqrtm_and_invsqrtm", "sqrtm_ns", "invsqrtm_ns", "polar", "psd_projection",
           "is_symmetric", "min_eig", "is_pd", "is_spd", "make_psd", "mean_cov",
           "symmetrize", "trace"]

STABILITY_CONST = 1e-8


def full_f32(fn):
    """Decorate ``fn`` so that its f32 matmuls run in full f32 on the card,
    with TF32 off for the call and the caller's setting restored after."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    return wrapper


def eye_like(matrices: torch.Tensor) -> torch.Tensor:
    """Identity broadcast to the shape, dtype and device of ``matrices``."""
    d1, d2 = matrices.shape[-2], matrices.shape[-1]
    eye = torch.eye(d1, d2, dtype=matrices.dtype, device=matrices.device)
    return eye.expand(matrices.shape)


def symmetrize(matrices: torch.Tensor) -> torch.Tensor:
    """0.5 · (M + Mᵀ)."""
    return 0.5 * (matrices + matrices.mT)


def trace(matrices: torch.Tensor) -> torch.Tensor:
    """Trace of each matrix [*, D, D] → [*]."""
    return torch.diagonal(matrices, dim1=-2, dim2=-1).sum(-1)


def _upcast(matrices: torch.Tensor) -> torch.Tensor:
    """bf16 and fp16 have no eigensolver: decompose in f32."""
    return matrices.float() if matrices.dtype.itemsize < 4 else matrices


def _f32_eigh(matrices: torch.Tensor):
    """(eigenvalues, eigenvectors) of the symmetric part, decomposed in at
    least f32 (JAX's eigh symmetrizes its input the same way), and the
    input's dtype to cast results back to."""
    return torch.linalg.eigh(symmetrize(_upcast(matrices))), matrices.dtype


def _from_eigh(v: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """V · diag(w) · Vᵀ."""
    return ((v * w[..., None, :]) @ v.mT).to(dtype)


def _eigh_apply(matrices: torch.Tensor, fn) -> torch.Tensor:
    """A scalar function applied to the eigenvalues of symmetric matrices."""
    (w, v), dtype = _f32_eigh(matrices)
    return _from_eigh(v, fn(w), dtype)


def _use_ns(method: str) -> bool:
    """``method`` of the sqrtm family: "eigh" (and "auto", on every device)
    or "ns" (Newton–Schulz)."""
    if method not in ("auto", "eigh", "ns"):
        raise ValueError(f"unknown sqrtm method {method!r}")
    return method == "ns"


@full_f32
def sqrtm(matrices: torch.Tensor, method: str = "eigh") -> torch.Tensor:
    """Principal square root of SPSD matrices [*, D, D], eigenvalues clamped
    at 0; ``method`` "eigh" | "ns" | "auto" (eigh)."""
    if _use_ns(method):
        return _ns_iterations(matrices, 30)[0]
    return _eigh_apply(matrices, lambda w: torch.sqrt(torch.clamp_min(w, 0.0)))


@full_f32
def invsqrtm(matrices: torch.Tensor, method: str = "eigh") -> torch.Tensor:
    """Inverse square root of SPD matrices, eigenvalues floored at
    ``STABILITY_CONST``; ``method`` as in :func:`sqrtm`."""
    if _use_ns(method):
        return _ns_iterations(matrices, 30)[1]
    return _eigh_apply(matrices, lambda w: torch.rsqrt(torch.clamp_min(w, STABILITY_CONST)))


@full_f32
def sqrtm_and_invsqrtm(matrices: torch.Tensor,
                       method: str = "eigh") -> Tuple[torch.Tensor, torch.Tensor]:
    """Square root and inverse square root from one decomposition."""
    if _use_ns(method):
        return _ns_iterations(matrices, 30)
    (w, v), dtype = _f32_eigh(matrices)
    return (_from_eigh(v, torch.sqrt(torch.clamp_min(w, 0.0)), dtype),
            _from_eigh(v, torch.rsqrt(torch.clamp_min(w, STABILITY_CONST)), dtype))


@full_f32
def _ns_iterations(matrices: torch.Tensor, num_iters: int,
                   refine: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coupled Newton–Schulz iteration → (√A, A^-½) on the input scaled by
    its Frobenius norm, with a relative ridge of 1e-6 that keeps
    near-singular inputs in the basin of convergence; ``refine`` Newton
    steps then take the ridge's bias out of the inverse root against the
    unridged input (the JAX package's ``_ns_iterations``)."""
    eye = eye_like(matrices)
    norm = torch.sqrt(torch.sum(matrices ** 2, dim=(-2, -1), keepdim=True))
    norm = torch.clamp_min(norm, STABILITY_CONST)
    a0 = matrices / norm
    y, z = a0 + 1e-6 * eye, eye
    for _ in range(num_iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    for _ in range(refine):
        z = 0.5 * (z @ (3.0 * eye - a0 @ (z @ z)))
    sqrt_norm = torch.sqrt(norm)
    return y * sqrt_norm, z / sqrt_norm


@full_f32
def polar(matrices: torch.Tensor, num_iters_lift: int = 12,
          num_iters_refine: int = 8) -> torch.Tensor:
    """Orthogonal polar factor U of square matrices (M = U·H, H = (MᵀM)^½),
    matmul-only: ``num_iters_lift`` quintic steps with the coefficients
    (3.4445, −4.7750, 2.0315), then ``num_iters_refine`` cubic steps
    X ← 1.5X − 0.5·X·XᵀX. Scale-invariant; exact-zero singular values stay
    zero (pseudo-polar on rank-deficient input)."""
    if matrices.shape[-1] != matrices.shape[-2]:
        raise ValueError(f"polar expects square matrices, got {tuple(matrices.shape)}")
    norm = torch.sqrt(torch.sum(matrices ** 2, dim=(-2, -1), keepdim=True))
    x = matrices / torch.clamp_min(norm, STABILITY_CONST)
    a, b, c = 3.4445, -4.7750, 2.0315
    for _ in range(num_iters_lift):
        xtx = x.mT @ x
        x_xtx = x @ xtx
        x = a * x + b * x_xtx + c * (x_xtx @ xtx)
    for _ in range(num_iters_refine):
        x = 1.5 * x - 0.5 * (x @ (x.mT @ x))
    return x


@full_f32
def psd_projection(matrices: torch.Tensor) -> torch.Tensor:
    """Nearest PSD matrix (Frobenius) to each symmetric matrix:
    (A + |A|)/2 with |A| = polar(A)ᵀ·A, negative eigenvalues clamped to 0."""
    u = polar(matrices)
    return symmetrize(0.5 * (matrices + u.mT @ matrices))


def sqrtm_ns(matrices: torch.Tensor, num_iters: int = 20) -> torch.Tensor:
    """Matrix square root by Newton–Schulz."""
    return _ns_iterations(matrices, num_iters)[0]


def invsqrtm_ns(matrices: torch.Tensor, num_iters: int = 20) -> torch.Tensor:
    """Inverse matrix square root by Newton–Schulz."""
    return _ns_iterations(matrices, num_iters)[1]


def is_symmetric(matrices: torch.Tensor) -> torch.Tensor:
    """Boolean [*]: Σ(M − Mᵀ)² below ``STABILITY_CONST``."""
    if matrices.shape[-1] != matrices.shape[-2]:
        return torch.zeros(matrices.shape[:-2], dtype=torch.bool, device=matrices.device)
    return torch.sum((matrices - matrices.mT) ** 2, dim=(-2, -1)) < STABILITY_CONST


def min_eig(matrices: torch.Tensor) -> torch.Tensor:
    """Smallest eigenvalue of each matrix's symmetric part [*]."""
    return torch.linalg.eigvalsh(symmetrize(_upcast(matrices))).amin(-1)


def is_pd(matrices: torch.Tensor, strict: bool = True) -> torch.Tensor:
    me = min_eig(matrices)
    return me > 0 if strict else me >= 0


def is_spd(matrices: torch.Tensor, strict: bool = True) -> torch.Tensor:
    return is_symmetric(matrices) & is_pd(matrices, strict=strict)


@full_f32
def _neg_part_norm(matrices: torch.Tensor) -> torch.Tensor:
    """‖(|A| − A)/2‖F of symmetric A, an upper bound on |λmin⁻| within √k
    of it (k negative eigenvalues), from the polar factor."""
    habs = symmetrize(polar(matrices).mT @ matrices)
    return torch.sqrt(torch.sum((0.5 * (habs - matrices)) ** 2, dim=(-2, -1)))


def make_psd(matrices: torch.Tensor, strict: bool = False, return_correction: bool = False,
             diag: bool = False,
             method: str = "eigh") -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Shift the diagonal by |λmin| where it is negative (plus
    ``STABILITY_CONST`` when ``strict``), unconditionally: the shift is 0
    on PSD input. ``method`` (full matrices): "eigh" (and "auto") measures
    λmin with ``eigvalsh``; "polar" bounds it by the negative part's
    Frobenius norm. ``diag`` takes variances [*, D] and their minimum."""
    if method == "auto":
        method = "eigh"
    if method not in ("eigh", "polar"):
        raise ValueError(f"unknown make_psd method {method!r}")
    if method == "polar" and not diag:
        smallest = -_neg_part_norm(symmetrize(matrices))
    else:
        smallest = matrices.amin(-1) if diag else min_eig(matrices)
    correction = torch.abs(torch.clamp_max(smallest, 0.0))
    if strict:
        correction = correction + STABILITY_CONST
    correction = correction.to(matrices.dtype)
    if diag:
        res = matrices + correction[..., None]
    else:
        res = matrices + eye_like(matrices) * correction[..., None, None]
    return (res, correction) if return_correction else res


def mean_cov(sum_: torch.Tensor, sum_corr: torch.Tensor, num_obs,
             diag: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and covariance from streaming sums (Σx [*, D], Σxxᵀ [*, D, D]
    or Σx² [*, D] when ``diag``, n broadcastable to the leading dims)."""
    n = torch.as_tensor(num_obs, dtype=sum_.dtype, device=sum_.device)
    mean = sum_ / n.reshape(*n.shape, *([1] * (sum_.dim() - n.dim())))
    cov = sum_corr / n.reshape(*n.shape, *([1] * (sum_corr.dim() - n.dim())))
    if diag:
        return mean, cov - mean ** 2
    return mean, cov - mean[..., :, None] * mean[..., None, :]
