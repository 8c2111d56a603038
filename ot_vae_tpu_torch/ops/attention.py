"""Packed-qkv multi-head attention: the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/attention_packed.cu``) replaces the TPU kernel
``_fwd_kernel_packed`` (``ot_vae_tpu/ops/attention_pallas.py``), reached there
through ``fused_attention_packed``. It computes softmax(scale·QKᵀ)V for every
head of one packed ``[B, T, 3·H·C]`` projection and the f32 log-sum-exp.

What bounds it on the H100: at the FFHQ128 decoder's 32² block (B=64, H=2,
C=64, T=1024) the products take 3.4e10 FLOP and the tensors 68 MB, so the
bound is the tensor-core rate (≈35 µs against ≈20 µs for the bytes). The
TPU kernel keeps a whole [T, T] instance in VMEM; an SM has 227 KB of shared
memory, so the CUDA kernel streams K/V tiles through shared memory with an
online softmax and keeps scores out of device memory. It runs on CUDA-core
FMAs, far above the bound; tensor cores are later work.

A CPU tensor takes :func:`attention_packed_reference`; a CUDA tensor launches
the kernel or raises. There is no fallback between them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

__all__ = ["attention_packed", "attention_packed_reference"]

# launches of the CUDA kernel in this process; read and reset it as
# ``attention.launch_count`` to count the launches of one run
launch_count = 0

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
    :return: out [B, T, H·C] in qkv's dtype, lse [B, T, H] f32
    """
    b, t, width = qkv.shape
    ch = _split(width, n_heads)
    heads = qkv.float().view(b, t, 3, n_heads, ch)
    q, k, v = (heads[:, :, i].transpose(1, 2) for i in range(3))  # [B,H,T,C]
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    weights = (p / denom).to(qkv.dtype).float()
    out = torch.matmul(weights, v).transpose(1, 2).reshape(b, t, n_heads * ch)
    lse = (m + torch.log(denom)).squeeze(-1).transpose(1, 2)
    return out.to(qkv.dtype), lse.contiguous()


def _launch(qkv: torch.Tensor, n_heads: int, scale: float):
    global launch_count
    from ot_vae_tpu_torch.ops._build import load_library

    b, t, width = qkv.shape
    ch = _split(width, n_heads)
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention kernel takes float32 or bfloat16, got {qkv.dtype}")
    if ch % 8 or ch > _MAX_HEAD_DIM:
        raise ValueError(f"attention kernel takes head dims that are multiples "
                         f"of 8 up to {_MAX_HEAD_DIM}, got {ch}")
    if not qkv.is_contiguous():
        raise ValueError("attention kernel takes a contiguous [B, T, 3·H·C] qkv")
    if qkv.data_ptr() % 16:
        raise ValueError("attention kernel needs a 16-byte aligned qkv")
    if b > 65535 or n_heads > 65535:
        raise ValueError(f"attention kernel grid limit: batch {b}, heads {n_heads}")
    lib = load_library("attention_packed")
    fn = lib.attention_packed_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((b, t, n_heads * ch), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, t, n_heads), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, t, n_heads,
                 ch, float(scale), _DTYPE_CODES[qkv.dtype], stream)
    if err != 0:
        raise RuntimeError(f"attention_packed_fwd launch failed: cudaError {err}")
    launch_count += 1
    return out, lse


def attention_packed(
    qkv: torch.Tensor, n_heads: int, scale: float = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(scale·QKᵀ)V per head on a packed [B, T, 3·H·C] projection.

    :param scale: logit scale, 1/sqrt(C) when None
    :return: out [B, T, H·C] in qkv's dtype, lse [B, T, H] f32
    """
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [B, T, 3·H·C], got {tuple(qkv.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(_split(qkv.shape[-1], n_heads))
    if qkv.device.type == "cpu":
        return attention_packed_reference(qkv, n_heads, scale)
    if qkv.device.type == "cuda":
        return _launch(qkv, n_heads, scale)
    raise ValueError(f"no attention kernel for device {qkv.device}")
