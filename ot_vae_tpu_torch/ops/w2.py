"""Optimal-transport helpers in plain PyTorch (counterpart:
``ot_vae_tpu/ops/w2.py``). Slice 3 carries ``sinkhorn_log``, the XLA path
of the JAX package, which ``CodebookModel.w2`` calls; the Gaussian W2 and
the rest of the OT core follow with their slice (ROADMAP)."""
from __future__ import annotations

import torch

from ot_vae_tpu_torch.ops.sinkhorn import STABILITY_CONST, SinkhornResult

__all__ = ["sinkhorn_log"]


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
