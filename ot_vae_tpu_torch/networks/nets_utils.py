"""Network building blocks (counterpart: ``ot_vae_tpu/networks/nets_utils.py``).

Tensors inside the networks are NCHW in ``channels_last`` memory; parameter
names follow the JAX package's module tree, so ``convert.py`` maps one onto
the other by path.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ot_vae_tpu_torch.ops.attention import fused_attention_packed

__all__ = [
    "div_sqrt",
    "get_activation",
    "BatchNorm",
    "Normalization",
    "EqualConv",
    "spatial_attention",
]


def div_sqrt(n: int) -> int:
    """Divisor of ``n`` closest to (and ≥) sqrt(n)."""
    if not (isinstance(n, int) and n > 0):
        raise ValueError(f"div_sqrt needs a positive int, got {n!r}")
    s = math.sqrt(n)
    return next(d for d in range(1, n + 1) if n % d == 0 and d >= s)


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if name is None or "none" in str(name).lower() or "null" in str(name).lower():
        return lambda x: x
    name = name.lower()
    if "leaky" in name:
        return lambda x: F.leaky_relu(x, 0.2)
    if "relu" in name:
        return F.relu
    if "selu" in name:
        return F.selu
    if "gelu" in name:
        return lambda x: F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    if "silu" in name or "swish" in name:
        return F.silu
    raise NotImplementedError(f"activation={name} not supported")


_BN_EPS = 1e-5  # flax nn.BatchNorm's default
_BN_MOMENTUM = 0.9  # ot_vae_tpu's Normalization


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9)`` with its eps of 1e-5, on NCHW.

    Train mode (``module.training``) normalises with the batch statistics,
    taken in f32 over N, H and W with flax's fast variance E[x²] − E[x]²
    (clipped at 0), and moves the running statistics as flax does:
    new = 0.9·old + 0.1·batch, with the *biased* batch variance.
    ``F.batch_norm(training=True)`` would feed the unbiased variance into
    ``running_var``, so it is not used. Eval mode normalises with the running
    statistics. Either way the arithmetic is f32 (f64 for f64 input) and the
    output is cast to ``dtype``."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.mul_(_BN_MOMENTUM).add_(mean, alpha=1.0 - _BN_MOMENTUM)
                self.running_var.mul_(_BN_MOMENTUM).add_(var, alpha=1.0 - _BN_MOMENTUM)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + _BN_EPS) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(dtype)


class Normalization(nn.Module):
    """none | batch. Group and instance norm come with the slices whose
    models use them."""

    def __init__(self, kind: Optional[str], features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kind = (kind or "none").lower()
        self.dtype = dtype
        if "none" in kind or "null" in kind:
            self.BatchNorm_0 = None
        elif "batch" in kind:
            self.BatchNorm_0 = BatchNorm(features)
        else:
            raise NotImplementedError(f"normalization={kind} is not ported yet")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.BatchNorm_0 is None:
            return x
        return self.BatchNorm_0(x, self.dtype)


class _ConvParams(nn.Module):
    """Holds a plain conv's weight and bias under flax's ``Conv_0`` name."""

    def __init__(self, shape: Sequence[int], use_bias: bool):
        super().__init__()
        fan_in = shape[1] * shape[2] * shape[3]
        self.weight = nn.Parameter(torch.randn(*shape) / math.sqrt(fan_in))
        self.bias = nn.Parameter(torch.zeros(shape[0])) if use_bias else None


class EqualConv(nn.Module):
    """Conv with optional equalized learning rate, explicit (lo, hi) padding
    per spatial axis, and an optional nearest ×``up_sample`` before it.

    The equalized-LR branch keeps the runtime fan-in scale
    ``lr_mult / sqrt(k·k·fan_in)`` on its weight and ``lr_mult`` on its bias.
    Upsampling is materialised (nearest, then the conv), the form the JAX
    package runs off the TPU.
    """

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1,
                 padding: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0), (0, 0)),
                 groups: int = 1, use_bias: bool = True,
                 equalized_lr: Optional[float] = None, up_sample: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        shape = (features, in_features // groups, kernel_size, kernel_size)
        self.stride, self.padding, self.groups = stride, padding, groups
        self.up_sample, self.dtype = up_sample, dtype
        self.equalized_lr = equalized_lr
        if equalized_lr is None:
            self.Conv_0 = _ConvParams(shape, use_bias)
        else:
            self.weight = nn.Parameter(torch.randn(*shape) / equalized_lr)
            self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
            self.scale = equalized_lr / math.sqrt(kernel_size * kernel_size * shape[1])

    def effective_params(self):
        """(weight, bias) as the conv applies them, in the parameters' dtype."""
        if self.equalized_lr is None:
            return self.Conv_0.weight, self.Conv_0.bias
        bias = None if self.bias is None else self.bias * self.equalized_lr
        return self.weight * self.scale, bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.effective_params()
        if self.up_sample > 1:
            x = F.interpolate(x, scale_factor=self.up_sample, mode="nearest")
        (h_lo, h_hi), (w_lo, w_hi) = self.padding
        pad = 0
        if h_lo == h_hi == w_lo == w_hi:
            pad = h_lo
        else:
            x = F.pad(x, (w_lo, w_hi, h_lo, h_hi))
        return F.conv2d(x.to(self.dtype), w.to(self.dtype),
                        None if b is None else b.to(self.dtype),
                        self.stride, pad, groups=self.groups)


def spatial_attention(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Multi-head self-attention over flattened spatial positions.

    :param qkv: [B, T, 3·H·C] packed queries/keys/values
    :return: [B, T, H·C]

    A CUDA tensor goes through the hand-written kernels at every T and head
    count (the TPU's T ≥ 512 threshold is not carried over), the forward
    kernel and, for its gradient, the backward kernel; a CPU tensor through
    their plain versions.
    """
    ch = qkv.shape[-1] // (3 * n_heads)
    return fused_attention_packed(qkv, n_heads, 1.0 / math.sqrt(ch))
