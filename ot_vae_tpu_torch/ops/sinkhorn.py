"""Log-domain entropic OT (Sinkhorn): the CUDA kernel's wrapper, its plain
PyTorch version and the dispatcher.

The kernel (``csrc/sinkhorn_log.cu``) replaces the TPU kernel ``_kernel``
(``ot_vae_tpu/ops/sinkhorn_pallas.py``), reached there through
``sinkhorn_log_pallas`` and ``sinkhorn_log_auto``. For each instance of a
batch it iterates v ← log b − LSE_rows(Cr + uᵀ), u ← log a − LSE_cols(Cr + v)
with Cr = −C/reg, until Σ|Δu| + Σ|Δv| < threshold or ``max_iter``, each
instance stopping on its own, and returns the plan exp(uᵀ + v + Cr).

What bounds it on the H100: 2·N·M exponentials per iteration (1.3e8 at
256² over 1000 iterations) on the SFUs; the kernel runs one thread block per
instance, so one instance uses one SM. See the source for the design.

:func:`sinkhorn_log_auto` is the counterpart of the JAX dispatcher: a CPU
tensor takes the plain version, every CUDA tensor launches the kernel (the
TPU's size window and batch ≤ 4 rule are not carried over), and a CUDA
tensor that is not f32 raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

__all__ = ["SinkhornResult", "sinkhorn_log_kernel", "sinkhorn_log_kernel_reference",
           "sinkhorn_log_auto"]

STABILITY_CONST = 1e-8
# shared memory a Hopper block may opt into (227 KB); the kernel keeps u, v,
# log a and log b there, 8·(N + M) bytes and 8 KB of scratch
_MAX_SHARED_BYTES = 232448

# launches of the CUDA kernel in this process; read and reset it as
# ``sinkhorn.launch_count`` to count the launches of one run
launch_count = 0


class SinkhornResult(NamedTuple):
    plan: torch.Tensor  # [*, N, M]
    num_iters: torch.Tensor  # [*] int32, iterations each instance ran
    err: torch.Tensor  # [*] the last iteration's Σ|Δu| + Σ|Δv| (inf before any)


def _flatten(a, b, cost):
    """a [*, N], b [*, M], C [*, N, M] → contiguous [B, N], [B, M], [B, N, M]."""
    if cost.dim() < 2:
        raise ValueError(f"cost must be [*, N, M], got {tuple(cost.shape)}")
    *batch, n, m = cost.shape
    a2 = torch.broadcast_to(a, (*batch, n)).reshape(-1, n)
    b2 = torch.broadcast_to(b, (*batch, m)).reshape(-1, m)
    return a2, b2, cost.reshape(-1, n, m), tuple(batch)


def sinkhorn_log_kernel_reference(
    a: torch.Tensor, b: torch.Tensor, cost: torch.Tensor, reg: float = 1e-5,
    max_iter: int = 1000, threshold: float = STABILITY_CONST,
    return_extra: bool = False,
):
    """Plain PyTorch version of the kernel's function: the same update order
    as ``_kernel`` (``sinkhorn_pallas.py:39-69``), each instance of the batch
    stopping on its own (an instance whose err fell below ``threshold`` keeps
    its u and v while the others iterate).

    :return: plan [*, N, M], or a :class:`SinkhornResult` with ``return_extra``
    """
    a2, b2, c2, batch = _flatten(a, b, cost)
    log_a = torch.log(a2 + STABILITY_CONST)
    log_b = torch.log(b2 + STABILITY_CONST)
    cr = -c2 / reg
    u, v = torch.zeros_like(log_a), torch.zeros_like(log_b)
    iters = torch.zeros(c2.shape[0], dtype=torch.int32, device=cost.device)
    err = torch.full((c2.shape[0],), float("inf"), dtype=cost.dtype, device=cost.device)
    active = torch.ones(c2.shape[0], dtype=torch.bool, device=cost.device)
    for _ in range(max_iter):
        v_new = log_b - torch.logsumexp(cr + u[:, :, None], dim=-2)
        u_new = log_a - torch.logsumexp(cr + v_new[:, None, :], dim=-1)
        step_err = (u_new - u).abs().sum(-1) + (v_new - v).abs().sum(-1)
        u = torch.where(active[:, None], u_new, u)
        v = torch.where(active[:, None], v_new, v)
        err = torch.where(active, step_err, err)
        iters += active.to(torch.int32)
        active = active & (step_err >= threshold)  # NaN stops, as in the kernel
        if not bool(active.any()):
            break
    plan = torch.exp(u[:, :, None] + v[:, None, :] + cr)
    plan = plan.reshape(*batch, *plan.shape[-2:])
    if return_extra:
        return SinkhornResult(plan, iters.reshape(batch), err.reshape(batch))
    return plan


def sinkhorn_log_kernel(
    a: torch.Tensor, b: torch.Tensor, cost: torch.Tensor, reg: float = 1e-5,
    max_iter: int = 1000, threshold: float = STABILITY_CONST,
    return_extra: bool = False,
):
    """Launch the CUDA kernel on f32 CUDA tensors a [*, N], b [*, M],
    C [*, N, M].

    :return: plan [*, N, M], or a :class:`SinkhornResult` with ``return_extra``
    """
    global launch_count
    from ot_vae_tpu_torch.ops._build import load_library

    for x, what in ((a, "a"), (b, "b"), (cost, "cost")):
        if x.device.type != "cuda" or x.device != cost.device:
            raise ValueError(f"{what}: the Sinkhorn kernel takes CUDA tensors on one device")
        if x.dtype != torch.float32:
            raise TypeError(f"{what}: the Sinkhorn kernel takes float32, got {x.dtype}")
    a2, b2, c2, batch = _flatten(a, b, cost)
    a2, b2, c2 = a2.contiguous(), b2.contiguous(), c2.contiguous()
    n_inst, n, m = c2.shape
    if n_inst > 2**31 - 1 or n_inst < 1:
        raise ValueError(f"Sinkhorn kernel grid limit: {n_inst} instances")
    lib = load_library("sinkhorn_log")
    smem = lib.sinkhorn_log_smem_bytes(n, m)
    if smem > _MAX_SHARED_BYTES:
        raise ValueError(f"Sinkhorn kernel: N={n}, M={m} need {smem} bytes of shared "
                         f"memory, a block may have {_MAX_SHARED_BYTES}")
    fn = lib.sinkhorn_log
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    plan = torch.empty_like(c2)
    iters = torch.empty(n_inst, dtype=torch.int32, device=cost.device)
    err = torch.empty(n_inst, dtype=torch.float32, device=cost.device)
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(a2.data_ptr(), b2.data_ptr(), c2.data_ptr(), plan.data_ptr(),
                  iters.data_ptr(), err.data_ptr(), n_inst, n, m, float(reg),
                  int(max_iter), float(threshold), stream)
    if code != 0:
        raise RuntimeError(f"sinkhorn_log launch failed: cudaError {code}")
    launch_count += 1
    plan = plan.reshape(*batch, n, m)
    if return_extra:
        return SinkhornResult(plan, iters.reshape(batch), err.reshape(batch))
    return plan


def sinkhorn_log_auto(
    a: torch.Tensor, b: torch.Tensor, cost: torch.Tensor, reg: float = 1e-5,
    max_iter: int = 1000, threshold: float = STABILITY_CONST,
    return_extra: bool = False,
):
    """Counterpart of ``sinkhorn_log_auto``: the plain version for a CPU
    tensor, the CUDA kernel for every CUDA tensor (a CUDA tensor that is not
    f32 raises). No size window, no batch limit, no fallback on the card."""
    if cost.device.type == "cpu":
        return sinkhorn_log_kernel_reference(a, b, cost, reg, max_iter, threshold,
                                             return_extra)
    if cost.device.type == "cuda":
        return sinkhorn_log_kernel(a, b, cost, reg, max_iter, threshold, return_extra)
    raise ValueError(f"no Sinkhorn kernel for device {cost.device}")
