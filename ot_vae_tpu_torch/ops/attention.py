"""Packed-qkv multi-head attention: the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/attention_packed.cu``) replaces the TPU kernel
``_fwd_kernel_packed`` (row 1, ``ot_vae_tpu/ops/attention_pallas.py``), reached
there through ``fused_attention_packed``. It computes softmax(scale·QKᵀ)V for
every head of one packed ``[B, T, 3·H·C]`` projection and the f32
log-sum-exp ``[B, T, H]``.

What bounds it on the H100: at the FFHQ128 decoder's 32² block (B=64, H=2,
C=64, T=1024) the products take 3.4e10 FLOP and the tensors 68 MB, so the
bound is the tensor-core rate (≈35 µs against ≈20 µs for the bytes). The
TPU kernel keeps a whole [T, T] instance in VMEM; an SM has 227 KB of shared
memory, so the CUDA kernels stream K/V tiles through shared memory with an
online softmax and keep scores out of device memory.

The backward kernel (``csrc/attention_packed_bwd.cu``) replaces
``_bwd_kernel_packed`` (row 2, reached through ``_fused_packed_bwd``); it
computes the packed ``dqkv`` from qkv, out, lse and dout. At the decoder's
block at the train batch (B=128, H=2, C=64, T=1024, bf16) that is 1.7e11
FLOP against 270 MB, so its bound is the tensor-core rate too (≈0.17 ms).
:func:`fused_attention_packed` ties the two together in a
``torch.autograd.Function``, as ``_fused_packed.defvjp`` does in the JAX
package, saving ``(qkv, out, lse)`` as its residuals.

In both libraries the dtype picks the kernel. bf16 runs on the tensor cores:
the packed layout is the BTHD layout read through strides (q, k and v are
the column blocks at 0, H·C and 2·H·C, all with token stride 3·H·C), so rows
1 and 2 run the ``mma.sync`` kernels of rows 7 and 8
(``csrc/attention_fwd_mma.cuh``, ``csrc/attention_bwd_mma.cuh``). f32 runs
on CUDA-core FMAs (``csrc/attention_packed_fwd.cuh``,
``attention_packed_bwd.cuh``), which keep f32 products exact where tensor
cores would take TF32. Both take every head dim C from 1 to 128 and every
T ≥ 1; the JAX package's d % 8 rule was a Mosaic lane rule of the TPU, not
a rule of the function.

The BTHD/BHTC forward kernel (``csrc/attention_bthd.cu``) replaces two TPU
kernels with one source that reads the layout through strides:
``_fwd_kernel_bthd`` (row 7, reached through ``fused_attention_bthd`` and
``fused_attention_bthd_dropout``) on q [B, Tq, H·d] and k, v [B, Tk, H·d],
with cross lengths, an in-kernel causal mask and a shared post-softmax
multiplier [Tq, Tk]; and ``_fwd_kernel`` (row 3, reached through
``fused_attention``) on [B, H, T, d]. At the FFHQ128 ViT encoder's layer
(B=64, H=4, d=128, T=1024, bf16) that is 1.37e11 FLOP against 268 MB, so
its bound is the tensor-core rate (≈0.14 ms). The ViT's attention takes
row 7 at every shape; row 3 has no model path in the port (the TPU reached
it only for head dims whose lanes do not tile 128). Their backward kernels
(``csrc/attention_bthd_bwd.cu``, one source again) replace
``_bwd_kernel_bthd`` (row 8) and ``_bwd_kernel`` (row 4); at the encoder's
layer at the train batch (B=32) the backward is 1.72e11 FLOP against 268
MB, bound by the tensor-core rate (≈0.17 ms). In both sources the dtype
picks the kernel: bf16 runs on the tensor cores (``mma.sync`` in 64-row
tiles, the flash-attention-2 design, the headers above on
``csrc/mma_bf16.cuh``), f32 on CUDA-core FMAs. :func:`fused_attention_bthd`,
:func:`fused_attention_bthd_dropout` and :func:`fused_attention` tie each
forward to its backward in a ``torch.autograd.Function``, saving the
residuals the JAX package's ``custom_vjp`` saves.

The fused attention block (``csrc/attention_block.cu``, row 5) replaces
``_block_fwd_kernel`` (reached through ``fused_attention_block``): the qkv
projection x·W_qkv, the packed attention and the output projection attn·W_out
in one call, through workspaces. Its backward
(``csrc/attention_block_bwd.cu``, row 6) replaces ``_block_bwd_kernel``:
it recomputes qkv and attn (from lse, P rounded as the TPU kernel rounds
it), runs the packed attention backward on (qkv, attn, lse, dAttn =
dO·W_outᵀ) and the three remaining projections, and sums the weight
gradients over the batch in fixed ranges added in order, with no atomics.
In both libraries the dtype picks the kernels, as in rows 1 and 2. bf16
runs on the tensor cores throughout: the f32 weights are rounded to bf16
once per call into a workspace; qkv is summed exactly on the FP64 tensor
cores and rounded once to f32, then to bf16, as the plain version's exact
sum rounds it (:func:`_project_qkv`), so that lse does not hang on the
order of the sum; the other projections and the weight gradients run a
bf16 ``mma.sync`` GEMM (``csrc/block_gemm.cuh``); the attention runs rows
1 and 2's kernels on the qkv workspace, and the backward's attention output
is recomputed from lse on ``mma.sync`` too. f32 runs on CUDA-core FMAs. At
the FFHQ128 decoder's 32² block (B=64, T=1024, H=2, ch=64, C=128) the
forward is 4.3e10 FLOP against 34 MB and the backward at the train batch
(B=128) 2.1e11 FLOP against about 100 MB: both are bound by the tensor-core
rate (0.043 and 0.21 ms). :func:`fused_attention_block` ties them together
in a ``torch.autograd.Function`` saving the JAX package's residuals
(x, W_qkv, W_out, lse).

A CPU tensor takes the plain versions (:func:`attention_packed_reference`,
:func:`attention_packed_backward_reference`, :func:`attention_bthd_reference`,
:func:`attention_bthd_backward_reference`, :func:`attention_bhtc_reference`,
:func:`attention_bhtc_backward_reference`, :func:`attention_block_reference`,
:func:`attention_block_backward_reference`) through the same autograd
Functions, so the CPU computes the kernels' function, bf16 rounding
included; a CUDA tensor launches the kernels or raises. There is no fallback
between them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

__all__ = ["attention_packed", "attention_packed_reference",
           "attention_packed_backward", "attention_packed_backward_reference",
           "fused_attention_packed", "attention_bthd", "attention_bthd_reference",
           "attention_bhtc", "attention_bhtc_reference", "attention_bthd_backward",
           "attention_bthd_backward_reference", "attention_bhtc_backward",
           "attention_bhtc_backward_reference", "fused_attention_bthd",
           "fused_attention_bthd_dropout", "fused_attention", "attention_block",
           "attention_block_reference", "attention_block_backward",
           "attention_block_backward_reference", "fused_attention_block"]

# launches of the forward and backward CUDA kernels in this process; read
# and reset them as ``attention.launch_count`` / ``backward_launch_count`` to
# count the launches of one run
launch_count = 0
backward_launch_count = 0
# launches of the BTHD (row 7) and BHTC (row 3) forward kernel entry points
bthd_launch_count = 0
bhtc_launch_count = 0
# launches of their backward kernels (rows 8 and 4)
bthd_bwd_launch_count = 0
bhtc_bwd_launch_count = 0
# launches of rows 7 and 8 that carried a multiplier (dropout in train mode)
mult_launch_count = 0
# launches of rows 7 and 8 with the in-kernel causal mask
causal_launch_count = 0
# calls of the fused attention block's forward (row 5) and backward (row 6):
# one each per call, however many CUDA launches the call makes
block_launch_count = 0
block_bwd_launch_count = 0
# dout tensors the autograd Functions had to copy into the contiguous layout
# the backward kernels read (on any device)
dout_copies = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


def _split(width: int, n_heads: int) -> int:
    if n_heads < 1 or width % (3 * n_heads):
        raise ValueError(f"packed qkv width {width} not divisible by 3·{n_heads}")
    return width // (3 * n_heads)


def attention_packed_reference(
    qkv: torch.Tensor, n_heads: int, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's function.

    Products run on the input values with f32 accumulation (both operands
    cast to f32, which is exact for bf16), softmax in f32, and the
    normalised probabilities are cast to v's dtype before P·V, as in the
    TPU kernel (``attention_pallas.py:266-276``).

    :param qkv: [B, T, 3·H·C] packed queries, keys, values (q block first,
        heads contiguous in each block)
    :return: out [B, T, H·C] in qkv's dtype, lse [B, T, H] f32 (f64 for
        f64 input)
    """
    b, t, width = qkv.shape
    ch = _split(width, n_heads)
    acc = torch.promote_types(qkv.dtype, torch.float32)  # f64 stays f64 (gradcheck)
    heads = qkv.to(acc).view(b, t, 3, n_heads, ch)
    q, k, v = (heads[:, :, i].transpose(1, 2) for i in range(3))  # [B,H,T,C]
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    weights = (p / denom).to(qkv.dtype).to(acc)
    out = torch.matmul(weights, v).transpose(1, 2).reshape(b, t, n_heads * ch)
    lse = (m + torch.log(denom)).squeeze(-1).transpose(1, 2)
    return out.to(qkv.dtype), lse.contiguous()


def attention_packed_backward_reference(
    qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    n_heads: int, scale: float,
) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel's function, step for step
    as ``_bwd_kernel_packed`` (``attention_pallas.py:279-317``):

    P = exp(scale·QKᵀ − lse); Δ = rowsum(dO∘O) in f32; dV = P(cast to dO's
    dtype)ᵀ·dO; dS = P∘(dO·Vᵀ − Δ)·scale cast to q's dtype; dQ = dS·K;
    dK = dSᵀ·Q. Products take f32 operands (exact for bf16) and accumulate in
    f32 (f64 for f64 input).

    :param qkv: [B, T, 3·H·C] the forward's input
    :param out: [B, T, H·C] the forward's output
    :param lse: [B, T, H] the forward's log-sum-exp
    :param dout: [B, T, H·C] gradient of ``out``
    :return: dqkv [B, T, 3·H·C] in qkv's dtype, in the packed column layout
    """
    b, t, width = qkv.shape
    ch = _split(width, n_heads)
    acc = torch.promote_types(qkv.dtype, torch.float32)

    def heads(x):  # [B, T, H·C] → [B, H, T, C] in the accumulation dtype
        return x.reshape(b, t, n_heads, ch).transpose(1, 2).to(acc)

    packed = qkv.reshape(b, t, 3, n_heads * ch)
    q, k, v = (heads(packed[:, :, i]) for i in range(3))
    o, do = heads(out), heads(dout)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.to(acc).transpose(1, 2).unsqueeze(-1))
    delta = (do * o).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(dout.dtype).to(acc).transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(qkv.dtype).to(acc)
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dqkv = torch.stack([g.transpose(1, 2) for g in (dq, dk, dv)], dim=2)
    return dqkv.reshape(b, t, width).to(qkv.dtype)


def _check_kernel_input(x: torch.Tensor, ch: int, what: str):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: attention kernels take float32 or bfloat16, got {x.dtype}")
    if not 1 <= ch <= _MAX_HEAD_DIM:
        raise ValueError(f"{what}: attention kernels take head dims 1 to "
                         f"{_MAX_HEAD_DIM}, got {ch}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: attention kernels take contiguous tensors")


def _check_grid(b: int, n_heads: int):
    if b > 65535 or n_heads > 65535:
        raise ValueError(f"attention kernel grid limit: batch {b}, heads {n_heads}")


def _uses_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; other devices raise."""
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"no attention kernel for device {x.device}")


def _check_same(x: torch.Tensor, like: torch.Tensor, ch: int, what: str):
    """A contiguous kernel input of ``like``'s dtype and device that starts on
    16 bytes where the kernels copy it in 16-byte chunks (head dims a
    multiple of 8), so that no such copy reads a misaligned address."""
    _check_kernel_input(x, ch, what)
    if x.dtype != like.dtype or x.device != like.device:
        raise ValueError(f"{what}: dtype and device must match the first input's")
    if ch % 8 == 0 and x.data_ptr() % 16:
        raise ValueError(f"{what}: the attention kernel needs 16-byte aligned tensors")


def _check_lse(lse: torch.Tensor, shape, like: torch.Tensor):
    if (tuple(lse.shape) != tuple(shape) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != like.device):
        raise ValueError(f"lse must be a contiguous f32 {tuple(shape)} on the inputs' device")


def _call(library: str, symbol: str, argtypes, args, device):
    from ot_vae_tpu_torch.ops._build import load_library

    fn = getattr(load_library(library), symbol)
    fn.argtypes = argtypes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")


def _launch(qkv: torch.Tensor, n_heads: int, scale: float):
    global launch_count
    b, t, width = qkv.shape
    ch = _split(width, n_heads)
    _check_same(qkv, qkv, ch, "qkv")
    _check_grid(b, n_heads)
    out = torch.empty((b, t, n_heads * ch), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, t, n_heads), dtype=torch.float32, device=qkv.device)
    _call("attention_packed", "attention_packed_fwd",
          [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int],
          [qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, t, n_heads, ch, float(scale),
           _DTYPE_CODES[qkv.dtype]], qkv.device)
    launch_count += 1
    return out, lse


def _launch_backward(qkv, out, lse, dout, n_heads: int, scale: float):
    global backward_launch_count
    b, t, width = qkv.shape
    ch = _split(width, n_heads)
    for x, what in ((qkv, "qkv"), (out, "out"), (dout, "dout")):
        _check_same(x, qkv, ch, what)
    if out.shape != (b, t, n_heads * ch) or dout.shape != out.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} "
                         f"must be [B, T, H·C] = {(b, t, n_heads * ch)}")
    _check_lse(lse, (b, t, n_heads), qkv)
    _check_grid(b, n_heads)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b, t, n_heads), dtype=torch.float32, device=qkv.device)
    _call("attention_packed_bwd", "attention_packed_bwd",
          [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int],
          [qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
           delta.data_ptr(), b, t, n_heads, ch, float(scale), _DTYPE_CODES[qkv.dtype]],
          qkv.device)
    backward_launch_count += 1
    return dqkv


def _check_qkv(qkv: torch.Tensor, n_heads: int, scale):
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [B, T, 3·H·C], got {tuple(qkv.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(_split(qkv.shape[-1], n_heads))
    return scale


def attention_packed(
    qkv: torch.Tensor, n_heads: int, scale: float = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(scale·QKᵀ)V per head on a packed [B, T, 3·H·C] projection.

    :param scale: logit scale, 1/sqrt(C) when None
    :return: out [B, T, H·C] in qkv's dtype, lse [B, T, H] f32
    """
    scale = _check_qkv(qkv, n_heads, scale)
    if _uses_kernel(qkv):
        return _launch(qkv, n_heads, scale)
    return attention_packed_reference(qkv, n_heads, scale)


def attention_packed_backward(
    qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    n_heads: int, scale: float = None,
) -> torch.Tensor:
    """dqkv [B, T, 3·H·C] of :func:`attention_packed` from its residuals and
    the output's gradient ``dout``."""
    scale = _check_qkv(qkv, n_heads, scale)
    if _uses_kernel(qkv):
        return _launch_backward(qkv, out, lse, dout, n_heads, scale)
    return attention_packed_backward_reference(qkv, out, lse, dout, n_heads, scale)


class _FusedAttentionPacked(torch.autograd.Function):
    """Forward kernel, backward kernel; residuals (qkv, out, lse) as in
    ``_fused_packed_fwd`` (``attention_pallas.py:351-353``)."""

    @staticmethod
    def forward(ctx, qkv, n_heads, scale):
        out, lse = attention_packed(qkv, n_heads, scale)
        ctx.save_for_backward(qkv, out, lse)
        ctx.n_heads, ctx.scale = n_heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        global dout_copies
        qkv, out, lse = ctx.saved_tensors
        if not dout.is_contiguous():
            dout = dout.contiguous()
            dout_copies += 1
        dqkv = attention_packed_backward(qkv, out, lse, dout, ctx.n_heads, ctx.scale)
        return dqkv, None, None


def fused_attention_packed(qkv: torch.Tensor, n_heads: int,
                           scale: float = None) -> torch.Tensor:
    """Differentiable :func:`attention_packed` (counterpart of
    ``fused_attention_packed``, ``attention_pallas.py:970``).

    :return: out [B, T, H·C] in qkv's dtype; its gradient runs the backward
        kernel on a CUDA tensor and the plain backward on a CPU tensor
    """
    scale = _check_qkv(qkv, n_heads, scale)
    return _FusedAttentionPacked.apply(qkv, n_heads, float(scale))


# --------------------------------------------------------------------------
# Separate q, k, v: BTHD [B, T, H·d] (rows 7 and 8) and BHTC [B, H, T, d]
# (rows 3 and 4)
# --------------------------------------------------------------------------


def _causal_above(tq: int, tk: int, device) -> torch.Tensor:
    return torch.ones(tq, tk, dtype=torch.bool, device=device).triu(1)


def _attention_heads(q, k, v, scale: float, causal: bool = False, mult=None):
    """softmax(scale·QKᵀ)[∘mult]·V on [B, H, T, d] heads, step for step as
    ``_fwd_kernel_bthd`` (``attention_pallas.py:676-707``): products on the
    input values with f32 accumulation (operands cast to f32, exact for
    bf16), softmax in f32, the normalised P (times ``mult``) cast to v's
    dtype before P·V.

    :return: out [B, H, Tq, d] in q's dtype, lse [B, H, Tq] f32 (f64 for
        f64 input)
    """
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(_causal_above(*s.shape[-2:], s.device), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    weights = p / denom
    if mult is not None:
        weights = weights * mult.to(acc)
    weights = weights.to(v.dtype).to(acc)
    out = torch.matmul(weights, v.to(acc)).to(q.dtype)
    return out, (m + torch.log(denom)).squeeze(-1)


def _attention_heads_backward(q, k, v, out, lse, dout, scale: float,
                              causal: bool = False, mult=None):
    """dq, dk, dv of :func:`_attention_heads` on [B, H, T, d] heads, step
    for step as ``_bwd_kernel_bthd`` (``attention_pallas.py:710-755``):

    P = exp(scale·QKᵀ − lse) (0 above the diagonal when causal); Δ =
    rowsum(dO∘O) in f32; Pd = P∘mult cast to dO's dtype, dV = Pdᵀ·dO;
    dP = (dO·Vᵀ)∘mult; dS = P∘(dP − Δ)·scale cast to q's dtype; dQ = dS·K;
    dK = dSᵀ·Q. Products take f32 operands (exact for bf16) and accumulate
    in f32 (f64 for f64 input).

    :param lse: [B, H, Tq] the forward's log-sum-exp
    :return: dq [B, H, Tq, d], dk and dv [B, H, Tk, d] in q's dtype
    """
    acc = torch.promote_types(q.dtype, torch.float32)
    qa, ka, va, o, do = (x.to(acc) for x in (q, k, v, out, dout))
    s = torch.matmul(qa, ka.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(_causal_above(*s.shape[-2:], s.device), float("-inf"))
    p = torch.exp(s - lse.to(acc).unsqueeze(-1))
    m = None if mult is None else mult.to(acc)
    pd = p if m is None else p * m
    delta = (do * o).sum(dim=-1, keepdim=True)
    dv = torch.matmul(pd.to(dout.dtype).to(acc).transpose(-1, -2), do)
    dp = torch.matmul(do, va.transpose(-1, -2))
    if m is not None:
        dp = dp * m
    ds = (p * (dp - delta) * scale).to(q.dtype).to(acc)
    dq = torch.matmul(ds, ka)
    dk = torch.matmul(ds.transpose(-1, -2), qa)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, width = x.shape
    return x.view(b, t, n_heads, width // n_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def _check_bthd(q, k, v, n_heads: int, scale, causal: bool, mult):
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q, k, v must be [B, T, H·d], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    b, tq, width = q.shape
    if n_heads < 1 or width % n_heads:
        raise ValueError(f"width {width} not divisible by {n_heads} heads")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != width:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"[{b}, Tk, {width}]")
    if causal and k.shape[1] != tq:
        raise ValueError("causal attention needs equal query and key lengths")
    if mult is not None and tuple(mult.shape) != (tq, k.shape[1]):
        raise ValueError(f"mult must be [Tq, Tk] = {(tq, k.shape[1])}, "
                         f"got {tuple(mult.shape)}")
    return 1.0 / math.sqrt(width // n_heads) if scale is None else scale


def attention_bthd_reference(q, k, v, n_heads: int, scale: float, causal: bool = False,
                             mult: torch.Tensor = None):
    """Plain PyTorch version of the BTHD kernel (row 7).

    :param q: [B, Tq, H·d]; k, v: [B, Tk, H·d]
    :param causal: query i sees keys ≤ i (Tq = Tk)
    :param mult: [Tq, Tk] post-softmax multiplier shared by batch and heads
    :return: out [B, Tq, H·d] in q's dtype, lse [B, H, Tq] f32
    """
    scale = _check_bthd(q, k, v, n_heads, scale, causal, mult)
    out, lse = _attention_heads(_split_heads(q, n_heads), _split_heads(k, n_heads),
                                _split_heads(v, n_heads), scale, causal, mult)
    return _merge_heads(out), lse


def attention_bthd_backward_reference(q, k, v, out, lse, dout, n_heads: int, scale: float,
                                      causal: bool = False, mult: torch.Tensor = None):
    """Plain PyTorch version of the BTHD backward kernel (row 8).

    :param out, dout: [B, Tq, H·d] the forward's output and its gradient
    :param lse: [B, H, Tq] the forward's log-sum-exp
    :return: dq [B, Tq, H·d], dk and dv [B, Tk, H·d] in q's dtype
    """
    scale = _check_bthd(q, k, v, n_heads, scale, causal, mult)
    grads = _attention_heads_backward(*(_split_heads(x, n_heads) for x in (q, k, v, out)),
                                      lse, _split_heads(dout, n_heads), scale, causal, mult)
    return tuple(_merge_heads(g) for g in grads)


def attention_bhtc_reference(q, k, v, scale: float):
    """Plain PyTorch version of the BHTC kernel (row 3), as ``_fwd_kernel``
    (``attention_pallas.py:109-127``).

    :param q, k, v: [B, H, T, d]
    :return: out [B, H, T, d] in q's dtype, lse [B·H, T] f32
    """
    b, h, t, _ = q.shape
    out, lse = _attention_heads(q, k, v, scale)
    return out, lse.reshape(b * h, t)


def attention_bhtc_backward_reference(q, k, v, out, lse, dout, scale: float):
    """Plain PyTorch version of the BHTC backward kernel (row 4), as
    ``_bwd_kernel`` (``attention_pallas.py:130-163``).

    :param q, k, v, out, dout: [B, H, T, d]; lse: [B·H, T]
    :return: dq, dk, dv [B, H, T, d] in q's dtype
    """
    b, h, t, _ = q.shape
    return _attention_heads_backward(q, k, v, out, lse.reshape(b, h, t), dout, scale)


def _launch_bthd(q, k, v, n_heads: int, scale: float, causal: bool, mult):
    global bthd_launch_count, mult_launch_count, causal_launch_count
    b, tq, width = q.shape
    tk, ch = k.shape[1], width // n_heads
    for x, what in ((q, "q"), (k, "k"), (v, "v"), (mult, "mult")):
        if x is not None:
            _check_same(x, q, ch, what)
    _check_grid(b, n_heads)
    out = torch.empty_like(q)
    lse = torch.empty((b, n_heads, tq), dtype=torch.float32, device=q.device)
    _call("attention_bthd", "attention_bthd_fwd",
          [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2,
          [q.data_ptr(), k.data_ptr(), v.data_ptr(),
           None if mult is None else mult.data_ptr(), out.data_ptr(), lse.data_ptr(),
           b, tq, tk, n_heads, ch, float(scale), int(causal), _DTYPE_CODES[q.dtype]],
          q.device)
    bthd_launch_count += 1
    if mult is not None:
        mult_launch_count += 1
    if causal:
        causal_launch_count += 1
    return out, lse


def _launch_bthd_backward(q, k, v, out, lse, dout, n_heads: int, scale: float, causal: bool,
                          mult):
    global bthd_bwd_launch_count, mult_launch_count, causal_launch_count
    b, tq, width = q.shape
    tk, ch = k.shape[1], width // n_heads
    for x, what in ((q, "q"), (k, "k"), (v, "v"), (out, "out"), (dout, "dout"),
                    (mult, "mult")):
        if x is not None:
            _check_same(x, q, ch, what)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must be "
                         f"q's {tuple(q.shape)}")
    _check_lse(lse, (b, n_heads, tq), q)
    _check_grid(b, n_heads)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, n_heads, tq), dtype=torch.float32, device=q.device)
    _call("attention_bthd_bwd", "attention_bthd_bwd",
          [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2,
          [q.data_ptr(), k.data_ptr(), v.data_ptr(),
           None if mult is None else mult.data_ptr(), out.data_ptr(), lse.data_ptr(),
           dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
           b, tq, tk, n_heads, ch, float(scale), int(causal), _DTYPE_CODES[q.dtype]],
          q.device)
    bthd_bwd_launch_count += 1
    if mult is not None:
        mult_launch_count += 1
    if causal:
        causal_launch_count += 1
    return dq, dk, dv


def _launch_bhtc(q, k, v, scale: float):
    global bhtc_launch_count
    b, h, t, ch = q.shape
    for x, what in ((q, "q"), (k, "k"), (v, "v")):
        _check_same(x, q, ch, what)
    _check_grid(b, h)
    out = torch.empty_like(q)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    _call("attention_bthd", "attention_bhtc_fwd",
          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int],
          [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
           b, h, t, ch, float(scale), _DTYPE_CODES[q.dtype]], q.device)
    bhtc_launch_count += 1
    return out, lse


def _launch_bhtc_backward(q, k, v, out, lse, dout, scale: float):
    global bhtc_bwd_launch_count
    b, h, t, ch = q.shape
    for x, what in ((q, "q"), (k, "k"), (v, "v"), (out, "out"), (dout, "dout")):
        _check_same(x, q, ch, what)
        if x.shape != q.shape:
            raise ValueError(f"{what} {tuple(x.shape)} must be q's {tuple(q.shape)}")
    _check_lse(lse, (b * h, t), q)
    _check_grid(b, h)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    _call("attention_bthd_bwd", "attention_bhtc_bwd",
          [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int],
          [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
           dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
           b, h, t, ch, float(scale), _DTYPE_CODES[q.dtype]], q.device)
    bhtc_bwd_launch_count += 1
    return dq, dk, dv


def attention_bthd(q, k, v, n_heads: int, scale: float = None, causal: bool = False,
                   mult: torch.Tensor = None):
    """softmax(scale·QKᵀ)[∘mult]·V per head on q [B, Tq, H·d] and k, v
    [B, Tk, H·d]: the row-7 kernel on a CUDA tensor, its plain version on a
    CPU tensor.

    :param scale: logit scale, 1/sqrt(d) when None
    :return: out [B, Tq, H·d] in q's dtype, lse [B, H, Tq] f32
    """
    scale = _check_bthd(q, k, v, n_heads, scale, causal, mult)
    if _uses_kernel(q):
        return _launch_bthd(q, k, v, n_heads, scale, causal, mult)
    return attention_bthd_reference(q, k, v, n_heads, scale, causal, mult)


def attention_bthd_backward(q, k, v, out, lse, dout, n_heads: int, scale: float = None,
                            causal: bool = False, mult: torch.Tensor = None):
    """dq, dk, dv of :func:`attention_bthd` from its residuals and the
    output's gradient ``dout``: the row-8 kernel on a CUDA tensor, its plain
    version on a CPU tensor. ``mult`` gets no gradient."""
    scale = _check_bthd(q, k, v, n_heads, scale, causal, mult)
    if _uses_kernel(q):
        return _launch_bthd_backward(q, k, v, out, lse, dout, n_heads, scale, causal, mult)
    return attention_bthd_backward_reference(q, k, v, out, lse, dout, n_heads, scale,
                                             causal, mult)


def _check_bhtc(q, k, v, scale):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, H, T, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def attention_bhtc(q, k, v, scale: float = None):
    """softmax(scale·QKᵀ)V per (batch, head) on [B, H, T, d]: the row-3
    kernel on a CUDA tensor, its plain version on a CPU tensor.

    :return: out [B, H, T, d] in q's dtype, lse [B·H, T] f32
    """
    scale = _check_bhtc(q, k, v, scale)
    if _uses_kernel(q):
        return _launch_bhtc(q, k, v, scale)
    return attention_bhtc_reference(q, k, v, scale)


def attention_bhtc_backward(q, k, v, out, lse, dout, scale: float = None):
    """dq, dk, dv [B, H, T, d] of :func:`attention_bhtc`: the row-4 kernel on
    a CUDA tensor, its plain version on a CPU tensor."""
    scale = _check_bhtc(q, k, v, scale)
    if _uses_kernel(q):
        return _launch_bhtc_backward(q, k, v, out, lse, dout, scale)
    return attention_bhtc_backward_reference(q, k, v, out, lse, dout, scale)


def _contiguous_dout(dout: torch.Tensor) -> torch.Tensor:
    """dout in the contiguous layout the backward kernels read; a copy is
    counted in ``dout_copies``."""
    global dout_copies
    if dout.is_contiguous():
        return dout
    dout_copies += 1
    return dout.contiguous()


class _FusedAttentionBTHD(torch.autograd.Function):
    """Row 7 forward, row 8 backward; residuals (q, k, v, mult, out, lse) as
    in ``_fused_bthd_drop_fwd`` (``attention_pallas.py:860-864``). The
    multiplier gets no gradient (the JAX package returns zeros for it)."""

    @staticmethod
    def forward(ctx, q, k, v, mult, n_heads, scale, causal):
        out, lse = attention_bthd(q, k, v, n_heads, scale, causal, mult)
        ctx.save_for_backward(q, k, v, mult, out, lse)
        ctx.n_heads, ctx.scale, ctx.causal = n_heads, scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mult, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bthd_backward(q, k, v, out, lse, _contiguous_dout(dout),
                                             ctx.n_heads, ctx.scale, ctx.causal, mult)
        return dq, dk, dv, None, None, None, None


class _FusedAttentionBHTC(torch.autograd.Function):
    """Row 3 forward, row 4 backward; residuals (q, k, v, out, lse) as in
    ``_fused_fwd`` (``attention_pallas.py:198-200``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = attention_bhtc(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bhtc_backward(q, k, v, out, lse, _contiguous_dout(dout),
                                             ctx.scale)
        return dq, dk, dv, None


def fused_attention_bthd(q, k, v, n_heads: int, scale: float = None,
                         causal: bool = False) -> torch.Tensor:
    """softmax(scale·QKᵀ)V on three [B, T, H·d] tensors (counterpart of
    ``fused_attention_bthd``, ``attention_pallas.py:895``); Tq ≠ Tk is
    allowed, ``causal`` masks keys after the query (Tq = Tk).

    :return: out [B, Tq, H·d] in q's dtype; its gradient runs the row-8
        kernel on a CUDA tensor and the plain backward on a CPU tensor
    """
    scale = _check_bthd(q, k, v, n_heads, scale, causal, None)
    return _FusedAttentionBTHD.apply(q, k, v, None, n_heads, float(scale), causal)


def fused_attention_bthd_dropout(q, k, v, mult: torch.Tensor, n_heads: int,
                                 scale: float = None, causal: bool = False) -> torch.Tensor:
    """:func:`fused_attention_bthd` with a post-softmax multiplier ``mult``
    [Tq, Tk] (dropout's keep mask over the keep probability, one for every
    batch element and head; counterpart of ``fused_attention_bthd_dropout``,
    ``attention_pallas.py:920``). The multiplier gets no gradient."""
    scale = _check_bthd(q, k, v, n_heads, scale, causal, mult)
    return _FusedAttentionBTHD.apply(q, k, v, mult.detach(), n_heads, float(scale), causal)


def fused_attention(q, k, v, scale: float = None) -> torch.Tensor:
    """softmax(scale·QKᵀ)V on [B, H, T, d] (counterpart of
    ``fused_attention``, ``attention_pallas.py:992``): rows 3 and 4 on a
    CUDA tensor, their plain versions on a CPU tensor."""
    scale = _check_bhtc(q, k, v, scale)
    return _FusedAttentionBHTC.apply(q, k, v, float(scale))


# --------------------------------------------------------------------------
# The fused attention block: qkv projection, packed attention, output
# projection (rows 5 and 6)
# --------------------------------------------------------------------------


def _check_block(x, w_qkv, w_out, n_heads: int, scale):
    """The JAX entry's shape asserts (``attention_pallas.py:964-966``);
    returns the scale, 1/sqrt(head dim) when None."""
    if x.dim() != 3 or w_qkv.dim() != 2 or w_out.dim() != 2:
        raise ValueError(f"x must be [B, T, C] and the weights 2-D, got {tuple(x.shape)}, "
                         f"{tuple(w_qkv.shape)}, {tuple(w_out.shape)}")
    width = w_qkv.shape[1]
    if w_qkv.shape[0] != x.shape[2]:
        raise ValueError(f"w_qkv {tuple(w_qkv.shape)} must be [C, 3·H·ch] for x "
                         f"{tuple(x.shape)}")
    ch = _split(width, n_heads)
    if w_out.shape[0] != width // 3:
        raise ValueError(f"w_out {tuple(w_out.shape)} must be [H·ch, C_out] = "
                         f"[{width // 3}, C_out]")
    return 1.0 / math.sqrt(ch) if scale is None else scale


def _block_operands(x, w_qkv, w_out):
    """The accumulation dtype (f32, f64 for f64 input) and both weights
    rounded to x's dtype, as ``_block_fwd_kernel`` casts them."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return acc, w_qkv.to(x.dtype).to(acc), w_out.to(x.dtype).to(acc)


def _project_qkv(x, wq, acc):
    """qkv = x·W_qkv rounded to x's dtype, W_qkv already rounded to it. For
    f32 and f64 the sum runs in ``acc``. For bf16 it is taken exactly (in
    f64: every product of two bf16 values is exact there, and so is every
    partial sum of these depths), rounded to f32 and then to bf16: the
    correctly rounded f32 accumulation, which the row-5 and row-6 kernels
    reach too (they sum on the FP64 tensor cores), so that an entry of qkv
    rounds to the same bf16 value whatever the order of the sum."""
    if x.dtype in (torch.float32, torch.float64):
        return torch.matmul(x.to(acc), wq).to(x.dtype)
    return torch.matmul(x.double(), wq.double()).float().to(x.dtype)


def attention_block_reference(x, w_qkv, w_out, n_heads: int,
                              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the row-5 kernel, step for step as
    ``_block_fwd_kernel`` (``attention_pallas.py:443-478``): the weights
    cast to x's dtype; qkv = x·W_qkv with f32 accumulation, rounded to x's
    dtype; per head softmax(scale·QKᵀ) with P normalised and rounded to v's
    dtype before P·V, attn_h rounded to x's dtype
    (:func:`attention_packed_reference`); out = Σ_h attn_h·W_out[h] in f32,
    rounded to x's dtype. In bf16 the qkv sum is the correctly rounded f32
    one (:func:`_project_qkv`).

    :param x: [B, T, C] the normalized block input
    :param w_qkv: [C, 3·H·ch] (q | k | v columns); w_out: [H·ch, C_out]
    :return: out [B, T, C_out] in x's dtype, lse [B, T, H] f32 (f64 for f64
        input)
    """
    acc, wq, wo = _block_operands(x, w_qkv, w_out)
    qkv = _project_qkv(x, wq, acc)
    attn, lse = attention_packed_reference(qkv, n_heads, scale)
    return torch.matmul(attn.to(acc), wo).to(x.dtype), lse


def attention_block_backward_reference(x, w_qkv, w_out, lse, dout, n_heads: int,
                                       scale: float):
    """Plain PyTorch version of the row-6 kernel, step for step as
    ``_block_bwd_kernel`` (``attention_pallas.py:481-553``): qkv recomputed
    and rounded, as the forward (:func:`_project_qkv`); P = exp(scale·QKᵀ −
    lse) and attn_h = P(rounded to v's dtype)·V rounded to x's dtype;
    dW_out = Σ attnᵀ·dO; dAttn = dO·W_outᵀ
    rounded to x's dtype; the packed backward of (qkv, attn, lse, dAttn)
    (:func:`attention_packed_backward_reference`: Δ = rowsum(dAttn∘attn) in
    f32, dS rounded) giving dqkv rounded to x's dtype; dX = dqkv·W_qkvᵀ and
    dW_qkv = Σ Xᵀ·dqkv.

    :param lse: [B, T, H] the forward's log-sum-exp
    :param dout: [B, T, C_out] gradient of the block's output
    :return: dx [B, T, C] in x's dtype; dw_qkv [C, 3·H·ch] and dw_out
        [H·ch, C_out], summed over the batch, in f32 (f64 for f64 input)
    """
    acc, wq, wo = _block_operands(x, w_qkv, w_out)
    b, t, _ = x.shape
    qkv = _project_qkv(x, wq, acc)
    ch = _split(qkv.shape[-1], n_heads)
    q, k, v = (h.transpose(1, 2) for h in qkv.to(acc).view(b, t, 3, n_heads, ch).unbind(2))
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * scale
                  - lse.to(acc).transpose(1, 2).unsqueeze(-1))
    attn = torch.matmul(p.to(x.dtype).to(acc), v).to(x.dtype)
    attn = attn.transpose(1, 2).reshape(b, t, n_heads * ch)
    dattn = torch.matmul(dout.to(acc), wo.t()).to(x.dtype)
    dqkv = attention_packed_backward_reference(qkv, attn, lse, dattn, n_heads, scale)
    dx = torch.matmul(dqkv.to(acc), wq.t()).to(x.dtype)
    dw_qkv = torch.einsum("btc,btn->cn", x.to(acc), dqkv.to(acc))
    dw_out = torch.einsum("btp,bto->po", attn.to(acc), dout.to(acc))
    return dx, dw_qkv, dw_out


def _check_weight(w: torch.Tensor, x: torch.Tensor, what: str):
    """The block kernels read f32 weights through their strides, so a
    transposed view needs no copy."""
    if w.dtype != torch.float32 or w.device != x.device:
        raise ValueError(f"{what}: the attention block kernels take f32 weights on x's "
                         f"device, got {w.dtype} on {w.device}")


def _like_weight(w: torch.Tensor) -> torch.Tensor:
    """An f32 gradient laid out as ``w`` where w is row- or column-major."""
    if w.t().is_contiguous() and not w.is_contiguous():
        return torch.empty_like(w.t(), dtype=torch.float32).t()
    return torch.empty(w.shape, dtype=torch.float32, device=w.device)


def _check_block_input(x: torch.Tensor, ch: int, what: str):
    _check_kernel_input(x, ch, what)
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: the attention block kernels need a 16-byte aligned tensor")


def _splits(rows: int, cols: int, depth: int, dtype, device) -> int:
    """K splits of a weight-gradient product: enough output tiles for two
    blocks on every SM, each split at least 256 rows deep. The tiles are the
    GEMM's of the dtype: [128, 128] for the bf16 tensor-core GEMM, [64, 64]
    for the f32 CUDA-core one. A function of the shape, the dtype and the
    card alone, so the sums' order repeats from run to run."""
    edge = 128 if dtype == torch.bfloat16 else 64
    tiles = -(-rows // edge) * -(-cols // edge)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-2 * sms // tiles), depth // 256))


def _weight_scratch(x, c: int, width: int, c_out: int):
    """The bf16 kernels' copy of both weights rounded to bf16, rows padded to
    a multiple of 8 entries: C·pad8(3·H·ch) + H·ch·pad8(C_out) entries; None
    for f32, whose kernels read the f32 weights themselves."""
    if x.dtype != torch.bfloat16:
        return None
    n = c * (-(-3 * width // 8) * 8) + width * (-(-c_out // 8) * 8)
    return torch.empty(n, dtype=torch.bfloat16, device=x.device)


def _launch_block(x, w_qkv, w_out, n_heads: int, scale: float):
    global block_launch_count
    b, t, c = x.shape
    ch = w_qkv.shape[1] // (3 * n_heads)
    width, c_out = n_heads * ch, w_out.shape[1]
    _check_block_input(x, ch, "x")
    _check_grid(b, n_heads)
    _check_weight(w_qkv, x, "w_qkv")
    _check_weight(w_out, x, "w_out")
    out = torch.empty((b, t, c_out), dtype=x.dtype, device=x.device)
    lse = torch.empty((b, t, n_heads), dtype=torch.float32, device=x.device)
    qkv = torch.empty((b, t, 3 * width), dtype=x.dtype, device=x.device)
    attn = torch.empty((b, t, width), dtype=x.dtype, device=x.device)
    w_ws = _weight_scratch(x, c, width, c_out)
    w_ws_ptr = None if w_ws is None else w_ws.data_ptr()
    _call("attention_block", "attention_block_fwd",
          [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
           ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64] + [ctypes.c_void_p] * 5
          + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int],
          [x.data_ptr(), w_qkv.data_ptr(), *w_qkv.stride(), w_out.data_ptr(), *w_out.stride(),
           out.data_ptr(), lse.data_ptr(), qkv.data_ptr(), attn.data_ptr(), w_ws_ptr,
           b, t, c, n_heads, ch, c_out, float(scale), _DTYPE_CODES[x.dtype]], x.device)
    block_launch_count += 1
    return out, lse


def _launch_block_backward(x, w_qkv, w_out, lse, dout, n_heads: int, scale: float):
    global block_bwd_launch_count
    b, t, c = x.shape
    ch = w_qkv.shape[1] // (3 * n_heads)
    width, c_out = n_heads * ch, w_out.shape[1]
    _check_block_input(x, ch, "x")
    _check_block_input(dout, ch, "dout")
    if dout.shape != (b, t, c_out) or dout.dtype != x.dtype or dout.device != x.device:
        raise ValueError(f"dout must be x's dtype and device, [B, T, C_out] = {(b, t, c_out)}, "
                         f"got {tuple(dout.shape)}")
    _check_lse(lse, (b, t, n_heads), x)
    _check_grid(b, n_heads)
    _check_weight(w_qkv, x, "w_qkv")
    _check_weight(w_out, x, "w_out")
    dx = torch.empty_like(x)
    dw_qkv, dw_out = _like_weight(w_qkv), _like_weight(w_out)

    def scratch(cols, dtype=x.dtype):
        return torch.empty((b * t, cols), dtype=dtype, device=x.device)

    qkv, dqkv, attn, dattn = scratch(3 * width), scratch(3 * width), scratch(width), scratch(width)
    delta = scratch(n_heads, torch.float32)
    splits_qkv = _splits(c, 3 * width, b * t, x.dtype, x.device)
    splits_out = _splits(width, c_out, b * t, x.dtype, x.device)
    split_ws = torch.empty(max(splits_qkv * c * 3 * width if splits_qkv > 1 else 0,
                               splits_out * width * c_out if splits_out > 1 else 0, 1),
                           dtype=torch.float32, device=x.device)
    w_ws = _weight_scratch(x, c, width, c_out)
    w_ws_ptr = None if w_ws is None else w_ws.data_ptr()
    _call("attention_block_bwd", "attention_block_bwd",
          [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
           ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
           ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64] + [ctypes.c_void_p] * 7
          + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int],
          [x.data_ptr(), w_qkv.data_ptr(), *w_qkv.stride(), w_out.data_ptr(), *w_out.stride(),
           lse.data_ptr(), dout.data_ptr(), dx.data_ptr(), dw_qkv.data_ptr(), *dw_qkv.stride(),
           dw_out.data_ptr(), *dw_out.stride(), qkv.data_ptr(), attn.data_ptr(),
           dattn.data_ptr(), dqkv.data_ptr(), delta.data_ptr(),
           split_ws.data_ptr(), w_ws_ptr, splits_qkv, splits_out, b, t, c, n_heads, ch,
           c_out, float(scale), _DTYPE_CODES[x.dtype]], x.device)
    block_bwd_launch_count += 1
    return dx, dw_qkv, dw_out


def attention_block(x, w_qkv, w_out, n_heads: int, scale: float = None):
    """attention(x·W_qkv)·W_out with per-head softmax attention: the row-5
    kernel on a CUDA tensor, its plain version on a CPU tensor.

    :param x: [B, T, C]; w_qkv: [C, 3·H·ch]; w_out: [H·ch, C_out] (f32 on
        the card, any strides)
    :param scale: logit scale, 1/sqrt(ch) when None
    :return: out [B, T, C_out] in x's dtype, lse [B, T, H] f32
    """
    scale = _check_block(x, w_qkv, w_out, n_heads, scale)
    if _uses_kernel(x):
        return _launch_block(x, w_qkv, w_out, n_heads, scale)
    return attention_block_reference(x, w_qkv, w_out, n_heads, scale)


def attention_block_backward(x, w_qkv, w_out, lse, dout, n_heads: int, scale: float = None):
    """dx, dw_qkv, dw_out of :func:`attention_block` from its residuals and
    the output's gradient ``dout``: the row-6 kernel on a CUDA tensor, its
    plain version on a CPU tensor. The weight gradients are f32 (f64 for f64
    input on the CPU), summed over the batch."""
    scale = _check_block(x, w_qkv, w_out, n_heads, scale)
    if _uses_kernel(x):
        return _launch_block_backward(x, w_qkv, w_out, lse, dout, n_heads, scale)
    return attention_block_backward_reference(x, w_qkv, w_out, lse, dout, n_heads, scale)


class _FusedAttentionBlock(torch.autograd.Function):
    """Row 5 forward, row 6 backward; residuals (x, W_qkv, W_out, lse) as in
    ``_fused_block_fwd`` (``attention_pallas.py:594-598``). The weight
    gradients come back in the weights' dtype."""

    @staticmethod
    def forward(ctx, x, w_qkv, w_out, n_heads, scale):
        out, lse = attention_block(x, w_qkv, w_out, n_heads, scale)
        ctx.save_for_backward(x, w_qkv, w_out, lse)
        ctx.n_heads, ctx.scale = n_heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w_qkv, w_out, lse = ctx.saved_tensors
        dx, dw_qkv, dw_out = attention_block_backward(
            x, w_qkv, w_out, lse, _contiguous_dout(dout), ctx.n_heads, ctx.scale)
        return dx, dw_qkv.to(w_qkv.dtype), dw_out.to(w_out.dtype), None, None


def fused_attention_block(x, w_qkv, w_out, n_heads: int, scale: float = None) -> torch.Tensor:
    """(x·W_qkv) → multi-head attention → (·W_out) (counterpart of
    ``fused_attention_block``, ``attention_pallas.py:945``): the block's
    projections and attention without its normalization.

    :param x: [B, T, C] the normalized block input
    :param w_qkv: [C, 3·H·ch] effective qkv weight (q | k | v column blocks,
        heads contiguous in each); w_out: [H·ch, C_out] effective output
        weight. On the card they are read through their strides, so the
        transposed [out, in] view of a 1×1 convolution's weight is no copy
    :param scale: logit scale, 1/sqrt(ch) when None
    :return: [B, T, C_out] in x's dtype; its gradient runs the row-6 kernel
        on a CUDA tensor and the plain backward on a CPU tensor
    """
    scale = _check_block(x, w_qkv, w_out, n_heads, scale)
    return _FusedAttentionBlock.apply(x, w_qkv, w_out, n_heads, float(scale))
