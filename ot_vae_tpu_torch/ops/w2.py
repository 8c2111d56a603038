"""Wasserstein-2 helpers in plain PyTorch (counterpart: ``ot_vae_tpu/ops/w2.py``):
the closed-form Gaussian W2 (Bures) distance, pairwise W2 between Gaussian
components, the entropic MW2 between Gaussian mixtures, the Gaussian
barycenter, the Monge operators of eq. 17/19 of Freirich, Michaeli, Meir and
their application, and ``sinkhorn_log``, the XLA path of the JAX package.

``method`` selects the spectral pipeline: "eigh" roots the product matrix
√Ct·Cs·√Ct by eigendecomposition; "polar" never forms it and takes every
cross term from U = polar(√Ct·√Cs) with Newton–Schulz roots of the two
covariances; "auto" is eigh on every device (the JAX package takes polar
only on the TPU). Functions compute in the input's dtype; products that build
an operator or a distance are full f32 (:func:`ot_vae_tpu_torch.ops.matrix.full_f32`).

``batch_ot_gmm`` couples mixtures with :func:`sinkhorn_log`, as the JAX
package does with its XLA Sinkhorn: that path has no TPU kernel and does
not go through the Sinkhorn kernel's dispatcher.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ot_vae_tpu_torch.ops.matrix import (
    STABILITY_CONST,
    eye_like,
    full_f32,
    make_psd,
    mean_cov,
    min_eig,
    polar,
    sqrtm,
    sqrtm_and_invsqrtm,
    symmetrize,
    trace,
)
from ot_vae_tpu_torch.ops.sinkhorn import SinkhornResult

__all__ = ["w2_gaussian", "bures_sqrt_trace", "batch_w2_dissimilarity_gaussian_diag",
           "batch_w2_dissimilarity_gaussian", "batch_ot_gmm", "sinkhorn_log",
           "gaussian_barycenter", "compute_transport_operators", "apply_transport",
           "mean_cov"]


def _polar_path(method: str) -> bool:
    """``method`` of the W2 family: "eigh", "polar" or "auto" (eigh)."""
    if method not in ("auto", "eigh", "polar"):
        raise ValueError(f"unknown W2 method {method!r}")
    return method == "polar"


def _mm(*ms: torch.Tensor) -> torch.Tensor:
    """Chained matmul (full f32 inside the decorated callers)."""
    out = ms[0]
    for m in ms[1:]:
        out = out @ m
    return out


def _make_pd(cov: torch.Tensor, method: str) -> torch.Tensor:
    """Shift a symmetrized covariance to PSD along the active pipeline: the
    diagonal shift by |λmin| (eigh) or by the negative part's Frobenius norm
    (polar). The shift also refloors every eigenvalue, which the Monge map
    would otherwise amplify as √(λ_target/λ_floor)."""
    return make_psd(symmetrize(cov), method="polar" if _polar_path(method) else "eigh")


@full_f32
def bures_sqrt_trace(cov_source: torch.Tensor, cov_target: torch.Tensor,
                     method: str = "auto") -> torch.Tensor:
    """tr (√Ct·Cs·√Ct)^½ [*, D, D] → [*]; on the polar path the nuclear norm
    of M = √Cs·√Ct, tr(Uᵀ·M) with U = polar(M)."""
    if _polar_path(method):
        m = _mm(sqrtm(cov_source, method="ns"), sqrtm(cov_target, method="ns"))
        return torch.sum(polar(m) * m, dim=(-2, -1))
    cov_target_sqrt = sqrtm(cov_target)
    mix = symmetrize(_mm(cov_target_sqrt, cov_source, cov_target_sqrt))
    return trace(sqrtm(mix))


@full_f32
def w2_gaussian(mean_source: torch.Tensor, mean_target: torch.Tensor,
                cov_source: torch.Tensor, cov_target: torch.Tensor, make_pd: bool = False,
                method: str = "auto") -> torch.Tensor:
    """Closed-form squared W2 between Gaussians: means [*, D], covariances
    [*, D, D] → [*]."""
    if make_pd:
        cov_source = _make_pd(cov_source, method)
        cov_target = _make_pd(cov_target, method)
    mean_shift = torch.sum((mean_source - mean_target) ** 2, dim=-1)
    return mean_shift + trace(cov_source + cov_target) - 2.0 * bures_sqrt_trace(
        cov_source, cov_target, method=method)


def _pairwise_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """‖aₙ − bₘ‖² for a [*, N, D], b [*, M, D] → [*, N, M]."""
    return (torch.sum(a ** 2, dim=-1, keepdim=True) + torch.sum(b ** 2, dim=-1)[..., None, :]
            - 2.0 * a @ b.mT)


@full_f32
def batch_w2_dissimilarity_gaussian_diag(mean_source: torch.Tensor, mean_target: torch.Tensor,
                                         var_source: torch.Tensor,
                                         var_target: torch.Tensor) -> torch.Tensor:
    """Pairwise W2² between diagonal Gaussians: means and variances
    [*, N, D] and [*, M, D] → [*, N, M]."""
    dist_var = (torch.sum(var_source, dim=-1, keepdim=True)
                + torch.sum(var_target, dim=-1)[..., None, :]
                - 2.0 * torch.sqrt(var_source) @ torch.sqrt(var_target).mT)
    return _pairwise_sq_dist(mean_source, mean_target) + dist_var


@full_f32
def batch_w2_dissimilarity_gaussian(mean_source: torch.Tensor, mean_target: torch.Tensor,
                                    cov_source: torch.Tensor, cov_target: torch.Tensor,
                                    make_pd: bool = False,
                                    method: str = "auto") -> torch.Tensor:
    """Pairwise W2² between full Gaussians: means [*, N, D] / [*, M, D],
    covariances [*, N, D, D] / [*, M, D, D] → [*, N, M], by broadcasting
    (source on dim -3, target on dim -2). The polar path roots each of the
    N + M covariances once and leaves the N·M pairs to matmuls."""
    if not _polar_path(method):
        return w2_gaussian(mean_source[..., :, None, :], mean_target[..., None, :, :],
                           cov_source[..., :, None, :, :], cov_target[..., None, :, :, :],
                           make_pd=make_pd, method=method)
    if make_pd:
        cov_source = _make_pd(cov_source, method)
        cov_target = _make_pd(cov_target, method)
    sqrt_s = sqrtm(cov_source, method="ns")  # [*, N, D, D]
    sqrt_t = sqrtm(cov_target, method="ns")  # [*, M, D, D]
    m = sqrt_s[..., :, None, :, :] @ sqrt_t[..., None, :, :, :]
    cross = torch.sum(polar(m) * m, dim=(-2, -1))
    return (_pairwise_sq_dist(mean_source, mean_target) + trace(cov_source)[..., :, None]
            + trace(cov_target)[..., None, :] - 2.0 * cross)


def sinkhorn_log(
    a: torch.Tensor, b: torch.Tensor, cost: torch.Tensor, reg: float = 1e-5,
    max_iter: int = 1000, threshold: float = STABILITY_CONST,
    return_extra: bool = False,
):
    """Entropic OT coupling by log-domain Sinkhorn, in the update order of
    ``ot_vae_tpu.ops.w2.sinkhorn_log``: v ← log b − LSE over rows (Cr + u),
    u ← log a − LSE over columns (Cr + v), Cr = −C/reg. The whole batch
    iterates until the largest Σ|Δu| + Σ|Δv| of its instances falls below
    ``threshold``, or ``max_iter`` times (the kernel's dispatcher instead
    stops each instance on its own, :mod:`ot_vae_tpu_torch.ops.sinkhorn`).

    :param a: source weights [*, N]
    :param b: target weights [*, M]
    :param cost: [*, N, M]
    :return: plan [*, N, M], or a ``SinkhornResult`` (plan, iterations as a
        0-d int32 tensor, the batch's largest err) with ``return_extra``
    """
    log_a = torch.log(a + STABILITY_CONST)
    log_b = torch.log(b + STABILITY_CONST)
    cr = -cost / reg
    u, v = torch.zeros_like(log_a), torch.zeros_like(log_b)
    iters, err = 0, torch.tensor(float("inf"), dtype=cost.dtype, device=cost.device)
    while iters < max_iter and bool(err >= threshold):
        v_new = log_b - torch.logsumexp(cr + u[..., :, None], dim=-2)
        u_new = log_a - torch.logsumexp(cr + v_new[..., None, :], dim=-1)
        diff = (u_new - u).abs().sum(-1) + (v_new - v).abs().sum(-1)
        u, v, iters, err = u_new, v_new, iters + 1, diff.max()
    plan = torch.exp(u[..., :, None] + v[..., None, :] + cr)
    if return_extra:
        return SinkhornResult(plan, torch.tensor(iters, dtype=torch.int32), err)
    return plan


@full_f32
def batch_ot_gmm(mean_source: torch.Tensor, mean_target: torch.Tensor,
                 cov_source: torch.Tensor, cov_target: torch.Tensor, diag: bool,
                 weight_source: Optional[torch.Tensor] = None,
                 weight_target: Optional[torch.Tensor] = None, method: str = "auto",
                 **sinkhorn_kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entropic MW2 between Gaussian mixtures: component means [*, N, D] /
    [*, M, D], covariances [*, N, D(, D)] / [*, M, D(, D)], weights [*, N] /
    [*, M] (uniform when None) → (total cost [*], coupling [*, N, M]). The
    cost matrix is scaled to a largest entry of 1 before :func:`sinkhorn_log`."""
    if weight_source is None:
        n = mean_source.shape[-2]
        weight_source = torch.full(mean_source.shape[:-1], 1.0 / n, dtype=mean_source.dtype,
                                   device=mean_source.device)
    if weight_target is None:
        m = mean_target.shape[-2]
        weight_target = torch.full(mean_target.shape[:-1], 1.0 / m, dtype=mean_target.dtype,
                                   device=mean_target.device)
    if diag:
        cost_matrix = batch_w2_dissimilarity_gaussian_diag(mean_source, mean_target,
                                                           cov_source, cov_target)
    else:
        cost_matrix = batch_w2_dissimilarity_gaussian(mean_source, mean_target, cov_source,
                                                      cov_target, make_pd=True, method=method)
    max_per_mat = torch.clamp_min(cost_matrix.amax(dim=(-2, -1), keepdim=True),
                                  STABILITY_CONST)
    coupling = sinkhorn_log(weight_source, weight_target, cost_matrix / max_per_mat,
                            **sinkhorn_kwargs)
    return torch.sum(cost_matrix * coupling, dim=(-2, -1)), coupling


@full_f32
def gaussian_barycenter(mean: torch.Tensor, cov: torch.Tensor, weights: torch.Tensor,
                        diag: bool, n_iter: int = 100,
                        method: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """W2 barycenter of Gaussian components [*, N, D] / [*, N, D(, D)] under
    weights [*, N] → (mean [*, D], cov [*, D(, D)]), by the fixed point
    B ← Σᵢ wᵢ (√B·Cᵢ·√B)^½ from the identity."""
    w = weights[..., None, :]
    mean_b = (w @ mean)[..., 0, :]
    if diag:
        return mean_b, (w @ torch.sqrt(cov))[..., 0, :] ** 2
    w_mat = weights[..., :, None, None]
    d = cov.shape[-1]
    cov_b = torch.eye(d, dtype=cov.dtype, device=cov.device).expand(
        *cov.shape[:-3], 1, d, d)
    if _polar_path(method):
        # (√B·Cᵢ·√B)^½ = sym(Uᵢᵀ·Mᵢ) with Mᵢ = √Cᵢ·√B; √Cᵢ is loop-invariant
        sqrt_c = sqrtm(cov, method="ns")
        for _ in range(n_iter):
            m = _mm(sqrt_c, sqrtm(cov_b, method="ns"))
            h = symmetrize(_mm(polar(m).mT, m))
            cov_b = torch.sum(w_mat * h, dim=-3, keepdim=True)
        return mean_b, cov_b[..., 0, :, :]
    for _ in range(n_iter):
        sqrt_cov_b = sqrtm(cov_b)
        mix = symmetrize(_mm(sqrt_cov_b, cov, sqrt_cov_b))
        cov_b = torch.sum(w_mat * sqrtm(mix), dim=-3, keepdim=True)
    return mean_b, cov_b[..., 0, :, :]


def _transport_diag(cov_source, cov_target, pg_star):
    """Eq. 17, diagonal."""
    T = (1.0 - pg_star) * torch.sqrt(cov_target / cov_source + STABILITY_CONST) + pg_star
    return T, torch.zeros_like(T)


def _transport_diag_stochastic(cov_source, cov_target, pg_star):
    """Eq. 19, diagonal."""
    T_star = torch.sqrt(cov_source / cov_target + STABILITY_CONST)
    pinv_source = torch.where(cov_source > STABILITY_CONST, 1.0 / cov_source,
                              torch.zeros_like(cov_source))
    T = (1.0 - pg_star) * torch.sqrt(cov_target * cov_source) * pinv_source + pg_star
    var_w = (math.sqrt(1.0 - pg_star) * cov_target
             * (1.0 - cov_target * pinv_source * T_star ** 2))
    return T, var_w


def _transport_full(cov_source, cov_target, pg_star, method="eigh"):
    """Eq. 17, full: Cs^-½·(√Cs·Ct·√Cs)^½·Cs^-½, on the polar path
    √Ct·U·Cs^-½ with U = polar(√Ct·√Cs)."""
    eye = eye_like(cov_source)
    if _polar_path(method):
        sqrt_s, isqrt_s = sqrtm_and_invsqrtm(cov_source + STABILITY_CONST * eye, method="ns")
        sqrt_t = sqrtm(cov_target, method="ns")
        u = polar(_mm(sqrt_t, sqrt_s))
        T = (1.0 - pg_star) * symmetrize(_mm(sqrt_t, u, isqrt_s)) + pg_star * eye
        return T, torch.zeros_like(T)
    sqrt_s, isqrt_s = sqrtm_and_invsqrtm(cov_source + STABILITY_CONST * eye)
    inner = sqrtm(symmetrize(_mm(sqrt_s, cov_target, sqrt_s)))
    T = (1.0 - pg_star) * _mm(isqrt_s, inner, isqrt_s) + pg_star * eye
    return T, torch.zeros_like(T)


def _pinv(a: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse with ``jnp.linalg.pinv``'s cutoff, 10·max(D)·eps of
    the largest singular value."""
    rtol = 10.0 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps
    return torch.linalg.pinv(a, rtol=rtol)


def _transport_full_stochastic(cov_source, cov_target, pg_star, method="eigh"):
    """Eq. 19, full: (T, Σw); on the polar path with U = polar(√Ct·√Cs),
    T = √Ct·U·Cs^-½ and the reverse operator T* = √Cs·Uᵀ·Ct^-½."""
    identity = eye_like(cov_source)
    ridge = STABILITY_CONST * identity
    if _polar_path(method):
        sqrt_s, isqrt_s = sqrtm_and_invsqrtm(cov_source + ridge, method="ns")
        sqrt_t, isqrt_t = sqrtm_and_invsqrtm(cov_target + ridge, method="ns")
        u = polar(_mm(sqrt_t, sqrt_s))
        pinv_source = _mm(isqrt_s, isqrt_s)
        T = (1.0 - pg_star) * symmetrize(_mm(sqrt_t, u, isqrt_s)) + pg_star * identity
        T_star = symmetrize(_mm(sqrt_s, u.mT, isqrt_t))
    else:
        pinv_source = _pinv(cov_source)
        sqrt_t, isqrt_t = sqrtm_and_invsqrtm(cov_target + ridge)
        # roles swapped on purpose: cov_source may be merely PSD
        T_star = _transport_full(cov_target, cov_source, 0.0)[0]
        inner = sqrtm(symmetrize(_mm(sqrt_t, cov_source, sqrt_t)))
        T = ((1.0 - pg_star) * _mm(sqrt_t, inner, isqrt_t, pinv_source)
             + pg_star * identity)
    Cw = math.sqrt(1.0 - pg_star) * _mm(
        sqrt_t, identity - _mm(sqrt_t, T_star, pinv_source, T_star, sqrt_t), sqrt_t)
    return T, Cw


@full_f32
def compute_transport_operators(cov_source: torch.Tensor, cov_target: torch.Tensor,
                                stochastic: bool, diag: bool, pg_star: float = 0.0,
                                make_pd: bool = False,
                                method: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """The W2 transport operators (T, Σw) of eq. 17 (Σw = 0) or eq. 19
    (``stochastic``) between covariances [*, D, D] (variances [*, D] when
    ``diag``). Where Σw of eq. 19 is not PSD (to ``STABILITY_CONST``), that
    batch element takes eq. 17's operator instead, element by element."""
    if diag:
        if not stochastic:
            return _transport_diag(cov_source, cov_target, pg_star)
        cov_source = torch.where(cov_source < STABILITY_CONST,
                                 torch.zeros_like(cov_source), cov_source)
        T, Cw = _transport_diag_stochastic(cov_source, cov_target, pg_star)
        T_det, Cw_det = _transport_diag(torch.clamp_min(cov_source, STABILITY_CONST),
                                        cov_target, pg_star)
        # strictly negative only: Cw == 0 (equal variances) is a valid
        # noiseless transport
        bad = torch.any(Cw < 0, dim=-1, keepdim=True)
        return torch.where(bad, T_det, T), torch.where(bad, Cw_det, Cw)

    if make_pd:
        cov_source = _make_pd(cov_source, method)
        cov_target = _make_pd(cov_target, method)
    if not stochastic:
        return _transport_full(cov_source, cov_target, pg_star, method)
    T, Cw = _transport_full_stochastic(cov_source, cov_target, pg_star, method)
    T_det, Cw_det = _transport_full(cov_source, cov_target, pg_star, method)
    if _polar_path(method):
        # Cholesky of Cw + εI succeeds iff min_eig(Cw) > −ε; ``info`` says
        # where it failed, per element and without a host sync
        shifted = symmetrize(Cw) + STABILITY_CONST * eye_like(Cw)
        bad = (torch.linalg.cholesky_ex(shifted.float()).info != 0)[..., None, None]
    else:
        bad = (min_eig(symmetrize(Cw)) < -STABILITY_CONST)[..., None, None]
    return torch.where(bad, T_det, T), torch.where(bad, Cw_det, Cw)


@full_f32
def apply_transport(inputs: torch.Tensor, mean_source: torch.Tensor,
                    mean_target: torch.Tensor, T: torch.Tensor, Cw: Optional[torch.Tensor] = None,
                    diag: bool = False, generator: Optional[torch.Generator] = None,
                    method: str = "auto") -> torch.Tensor:
    """T·(x − μs) + μt for samples [*, D], plus noise ~ N(0, Σw) when both
    ``Cw`` and ``generator`` are given (the noise scale √Σw by the active
    pipeline)."""
    x_centered = inputs - mean_source
    if diag:
        moved = T * x_centered
    else:
        moved = (T @ x_centered[..., :, None])[..., 0]
    moved = moved + mean_target
    if Cw is None or generator is None:
        return moved
    eps = torch.randn(moved.shape, generator=generator, dtype=moved.dtype,
                      device=moved.device)
    if diag:
        return moved + torch.sqrt(torch.clamp_min(Cw, 0.0)) * eps
    if _polar_path(method):
        # PSD shift first: an admitted Cw can sit a hair indefinite, and a
        # degenerate one far outside the Newton–Schulz basin relative to its
        # size
        scale = sqrtm(make_psd(symmetrize(Cw), method="polar"), method="ns")
    else:
        scale = sqrtm(symmetrize(Cw))
    return moved + (scale @ eps[..., :, None])[..., 0]
