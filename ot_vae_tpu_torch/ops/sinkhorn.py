"""Log-domain entropic OT (Sinkhorn): the CUDA kernel's wrapper, its plain
PyTorch version and the dispatcher.

The kernel (``csrc/sinkhorn_log.cu``) replaces the TPU kernel ``_kernel``
(``ot_vae_tpu/ops/sinkhorn_pallas.py``), reached there through
``sinkhorn_log_pallas`` and ``sinkhorn_log_auto``. For each instance of a
batch it iterates v ← log b − LSE_rows(Cr + uᵀ), u ← log a − LSE_cols(Cr + v)
with Cr = −C/reg, until Σ|Δu| + Σ|Δv| < threshold or ``max_iter``, each
instance stopping on its own, and returns the plan exp(uᵀ + v + Cr).

What bounds it on the H100: 2·N·M exponentials per iteration (1.3e8 at
256² over 1000 iterations) on the SFUs. The kernel spreads each instance
over a thread-block cluster of :data:`CLUSTER` CTAs, each holding a band of
Cr's rows in its shared memory (:func:`_launch_plan`); see the source for
the design.

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
# the kernel's constants (csrc/sinkhorn_log.cu, kCluster, kThreads,
# kMaxSlices, kMaxShared), which the C side checks the launch plan against:
# CTAs an instance, threads a CTA, row-pass partials a column a CTA at most,
# and the dynamic shared memory a Hopper block may opt into (227 KB)
CLUSTER = 8
THREADS = 512
MAX_SLICES = 4
MAX_SHARED_BYTES = 232448

# launches of the CUDA kernel in this process; read and reset it as
# ``sinkhorn.launch_count`` to count the launches of one run
launch_count = 0


class LaunchPlan(NamedTuple):
    cluster: int  # CTAs an instance
    rows: int  # rows of Cr a CTA's band holds, ceil(N / cluster)
    resident: int  # of them, rows kept in the CTA's shared memory
    streamed: int  # of them, rows streamed from the plan buffer (rows - resident)
    slices: int  # row-pass partials a column a CTA
    smem_bytes: int  # dynamic shared memory a CTA


def _launch_plan(n: int, m: int) -> LaunchPlan:
    """The kernel's launch plan for an N × M instance, as the source lays out
    its shared memory: f64 warp sums of err [THREADS / 32] and every CTA's
    share of err [CLUSTER], then f32 v [M], log b of the CTA's column slice
    [Mc = ceil(M / CLUSTER)], u and log a of its band [rows] each, the inbox
    of row-pass partial maxima and sums of its column slice
    [CLUSTER · slices, Mc + 1] each, and as many of the band's rows of Cr
    [M each] as fit beside them. Raises ValueError where the fixed part
    alone does not fit (M above about 18,500)."""
    if n < 1 or m < 1:
        raise ValueError(f"Sinkhorn kernel: N={n}, M={m}")
    rows = -(-n // CLUSTER)
    slices = min(MAX_SLICES, max(1, THREADS // m), rows)
    mc = -(-m // CLUSTER)
    fixed = 8 * (THREADS // 32 + CLUSTER) + 4 * (m + mc + 2 * rows
                                                 + 2 * (mc + 1) * CLUSTER * slices)
    if fixed > MAX_SHARED_BYTES:
        raise ValueError(
            f"Sinkhorn kernel: N={n}, M={m} need {fixed} bytes of shared memory a CTA for "
            f"v, u and the row-pass partials, a block may have {MAX_SHARED_BYTES}")
    resident = min(rows, (MAX_SHARED_BYTES - fixed) // (4 * m))
    return LaunchPlan(CLUSTER, rows, resident, rows - resident, slices,
                      fixed + 4 * resident * m)


def _uses_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; other devices raise."""
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"no Sinkhorn kernel for device {x.device}")


def _call(symbol: str, argtypes, args, device):
    """Call ``symbol`` of the kernel's library on ``device``'s current
    stream; a refused launch raises."""
    from ot_vae_tpu_torch.ops._build import load_library

    fn = getattr(load_library("sinkhorn_log"), symbol)
    fn.argtypes = argtypes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        code = fn(*args, torch.cuda.current_stream().cuda_stream)
    if code == -1:
        raise RuntimeError(f"{symbol}: no cluster of the launch plan's size and shared "
                           f"memory can be scheduled on {device}")
    if code != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {code}")


def active_clusters(n: int, m: int, device=None) -> int:
    """How many clusters of the N × M launch plan the card can run at once
    (``cudaOccupancyMaxActiveClusters``; 0 when none can be scheduled)."""
    from ot_vae_tpu_torch.ops._build import load_library

    _launch_plan(n, m)
    fn = load_library("sinkhorn_log").sinkhorn_log_active_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    clusters = ctypes.c_int(0)
    with torch.cuda.device(device):
        code = fn(n, m, ctypes.byref(clusters))
    if code != 0:
        raise RuntimeError(f"sinkhorn_log_active_clusters failed: cudaError {code}")
    return clusters.value


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
    for x, what in ((a, "a"), (b, "b"), (cost, "cost")):
        if not _uses_kernel(x) or x.device != cost.device:
            raise ValueError(f"{what}: the Sinkhorn kernel takes CUDA tensors on one device")
        if x.dtype != torch.float32:
            raise TypeError(f"{what}: the Sinkhorn kernel takes float32, got {x.dtype}")
    a2, b2, c2, batch = _flatten(a, b, cost)
    a2, b2, c2 = a2.contiguous(), b2.contiguous(), c2.contiguous()
    n_inst, n, m = c2.shape
    lp = _launch_plan(n, m)
    if n_inst < 1 or n_inst * lp.cluster > 2**31 - 1:
        raise ValueError(f"Sinkhorn kernel grid limit: {n_inst} instances")
    plan = torch.empty_like(c2)
    iters = torch.empty(n_inst, dtype=torch.int32, device=cost.device)
    err = torch.empty(n_inst, dtype=torch.float32, device=cost.device)
    _call("sinkhorn_log",
          [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                                         ctypes.c_float],
          [a2.data_ptr(), b2.data_ptr(), c2.data_ptr(), plan.data_ptr(), iters.data_ptr(),
           err.data_ptr(), n_inst, n, m, lp.cluster, lp.rows, lp.resident, lp.slices,
           lp.smem_bytes, float(reg), int(max_iter), float(threshold)],
          cost.device)
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
    if _uses_kernel(cost):
        return sinkhorn_log_kernel(a, b, cost, reg, max_iter, threshold, return_extra)
    return sinkhorn_log_kernel_reference(a, b, cost, reg, max_iter, threshold, return_extra)
