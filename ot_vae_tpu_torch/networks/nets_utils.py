"""Network building blocks (counterpart: ``ot_vae_tpu/networks/nets_utils.py``).

Tensors inside the CNN are NCHW in ``channels_last`` memory; parameter
names follow the JAX package's module tree, so ``convert.py`` maps one onto
the other by path. The flax layers the ViT is built from (``Dense``,
``LayerNorm``, ``Embed``, ``MultiHeadDotProductAttention``) keep flax's
parameter names and shapes as well (a Dense kernel is [in, out]), and
:func:`mha_attention_fn` routes their attention as the JAX package's does.

Every dropout site, :class:`Dropout` and the attention weights' multiplier
alike, draws its keep mask through :func:`dropout_keep` from a generator the
caller hands down; train mode with a rate above 0 and no generator raises,
and nothing draws from torch's global generator.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ot_vae_tpu_torch.ops.attention import (
    fused_attention_bthd,
    fused_attention_bthd_dropout,
    fused_attention_packed,
)

__all__ = [
    "div_sqrt",
    "lecun_normal",
    "get_activation",
    "BatchNorm",
    "Normalization",
    "EqualConv",
    "EqualDense",
    "GaussianFourierProjection",
    "spatial_attention",
    "Dense",
    "LayerNorm",
    "Embed",
    "dropout_keep",
    "Dropout",
    "KVCache",
    "MultiHeadDotProductAttention",
    "mha_attention_fn",
    "dot_product_attention",
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


# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal(*shape: int, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at 2 standard deviations,
    rescaled to std 1/sqrt(``fan_in``), drawn from torch's generator. The
    default of flax's Dense, DenseGeneral and Conv kernels."""
    w = nn.init.trunc_normal_(torch.empty(*shape), 0.0, 1.0, -2.0, 2.0)
    return w / (math.sqrt(fan_in) * _TRUNCATED_STD)


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
        self.weight = nn.Parameter(lecun_normal(*shape, fan_in=fan_in))
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


class EqualDense(nn.Module):
    """Dense layer with an equalized learning rate: the kernel [in, out] is
    drawn at std 1/``lr_mult`` and scaled by lr_mult / sqrt(in) at run time,
    the bias by ``lr_mult``."""

    def __init__(self, in_features: int, features: int, lr_mult: float = 1.0,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lr_mult, self.dtype = lr_mult, dtype
        self.scale = float(lr_mult / math.sqrt(in_features))
        self.kernel = nn.Parameter(torch.randn(in_features, features) / lr_mult)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype) @ (self.kernel * self.scale).to(self.dtype)
        if self.bias is not None:
            y = y + (self.bias * self.lr_mult).to(self.dtype)
        return y


class GaussianFourierProjection(nn.Module):
    """Gaussian random features of a time t in [0, 1]: [sin, cos] of
    t·w·2π with w [1, dim // 2] drawn at std ``scale``, then, with
    ``out_dim``, ``n_layers`` Dense layers with a ReLU between them. Without
    ``trainable`` no gradient reaches ``weight``."""

    def __init__(self, dim: int, out_dim: Optional[int] = None, n_layers: int = 3,
                 scale: float = 30.0, trainable: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trainable, self.scale = trainable, scale
        self.weight = nn.Parameter(torch.randn(1, dim // 2) * scale)
        self.n_layers = 0 if out_dim is None else n_layers
        for i in range(self.n_layers):
            setattr(self, f"Dense_{i}", Dense(out_dim if i else 2 * (dim // 2), out_dim, dtype))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        if t.dim() != 1:
            raise ValueError("`t` is expected to be 1-dimensional")
        w = self.weight if self.trainable else self.weight.detach()
        # the JAX order of operations: the argument reaches hundreds of
        # radians, where another rounding order shows in the output
        proj = t[:, None] * w * 2.0 * math.pi
        h = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
        for i in range(self.n_layers):
            h = getattr(self, f"Dense_{i}")(F.relu(h) if i else h)
        return h


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


# ---------------------------------------------------------------- flax layers


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x·kernel + bias with kernel [in, out], inputs,
    kernel and bias cast to ``dtype`` first (f32 parameters, bf16 compute
    when ``dtype`` is bf16)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal(in_features, features, fan_in=in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.kernel.t().to(self.dtype),
                        self.bias.to(self.dtype))


_LN_EPS = 1e-6  # flax nn.LayerNorm's default


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis, ε = 1e-6: statistics in f32
    (f64 for f64 input) with flax's fast variance E[x²] − E[x]² clipped at
    0, normalised and scaled in f32, cast to ``dtype``. The fast variance
    loses about mean²/var f32 ulps of the variance against the two-pass
    E[(x − E[x])²] of ``F.layer_norm``: on the CPU the outputs differ by
    2e-6 of their range for unit-variance rows and by 1.3e-5 for rows whose
    mean is 8 standard deviations off zero (tests/test_torch_vit.py)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        y = (x - mean) * (torch.rsqrt(var + _LN_EPS) * self.scale)
        return (y + self.bias).to(self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: rows of ``embedding`` [num, features], cast to
    ``dtype``."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.randn(num_embeddings, features)
                                      / math.sqrt(features))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.embedding.to(self.dtype)[idx.long()]


class _HeadProjection(nn.Module):
    """flax ``DenseGeneral`` of the attention: ``features_in`` [dim] →
    [H, d] (kernel [dim, H, d], bias [H, d]) or, with ``merge``, [H, d] →
    [dim] (kernel [H, d, dim], bias [dim])."""

    def __init__(self, dim: int, heads: int, head_dim: int, merge: bool, dtype):
        super().__init__()
        self.merge, self.dtype = merge, dtype
        shape = (heads, head_dim, dim) if merge else (dim, heads, head_dim)
        fan_in = heads * head_dim if merge else dim
        self.kernel = nn.Parameter(lecun_normal(*shape, fan_in=fan_in))
        self.bias = nn.Parameter(torch.zeros(dim if merge else (heads, head_dim)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.to(self.dtype)
        if self.merge:  # [B, T, H, d] → [B, T, dim]
            return F.linear(x.flatten(-2).to(self.dtype), k.flatten(0, 1).t(),
                            self.bias.to(self.dtype))
        y = F.linear(x.to(self.dtype), k.flatten(1).t(), self.bias.flatten().to(self.dtype))
        return y.unflatten(-1, k.shape[1:])


def dropout_keep(shape, keep_prob: float, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """The keep mask of one dropout site: a boolean tensor of ``shape``, True
    with probability ``keep_prob``, drawn from ``generator`` (on ``device``).
    The counterpart of ``jax.random.bernoulli`` at flax's dropout sites.

    :raises ValueError: without a generator
    """
    if generator is None:
        raise ValueError("dropout in train mode needs a generator (dropout_rng)")
    return torch.rand(tuple(shape), generator=generator, device=device) < keep_prob


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode (``module.training``) with rate r
    > 0, ``where(keep, x / (1 − r), 0)`` in x's dtype (1 − r rounded to it
    first, as JAX rounds a Python scalar) with an elementwise keep mask drawn
    from ``generator``; the identity in eval mode or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep_prob = 1.0 - self.rate
        keep = dropout_keep(x.shape, keep_prob, generator, x.device)
        scaled = x / torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
        return torch.where(keep, scaled, torch.zeros((), dtype=x.dtype, device=x.device))


def dot_product_attention(query, key, value, bias=None, mask=None,
                          broadcast_dropout: bool = True,
                          dropout_rng: Optional[torch.Generator] = None,
                          dropout_rate: float = 0.0, deterministic: bool = False,
                          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax ``dot_product_attention`` in plain torch, the path of calls no
    kernel takes (a bias, an arbitrary mask, per-element dropout): the query
    scaled by 1/sqrt(d), logits with ``bias`` added and masked-out entries
    set to the dtype's lowest value, softmax in the compute dtype, dropout
    of the weights, weights·V.

    :param query: [B, Tq, H, d]; key, value: [B, Tk, H, d]
    :param mask: boolean, broadcastable to [B, H, Tq, Tk]; True keeps
    :return: [B, Tq, H, d]
    """
    dtype = dtype or query.dtype
    d = query.shape[-1]
    query = query.to(dtype) / math.sqrt(d)
    weights = torch.einsum("bqhd,bkhd->bhqk", query, key.to(dtype))
    if bias is not None:
        weights = weights + bias.to(dtype)
    if mask is not None:
        weights = weights.masked_fill(~mask.bool(), torch.finfo(dtype).min)
    weights = torch.softmax(weights, dim=-1).to(dtype)
    if not deterministic and dropout_rate > 0.0:
        keep_prob = 1.0 - dropout_rate
        shape = (1, 1, *weights.shape[-2:]) if broadcast_dropout else weights.shape
        keep = dropout_keep(shape, keep_prob, dropout_rng, weights.device)
        weights = weights * (keep.to(dtype) / torch.tensor(keep_prob, dtype=dtype,
                                                           device=weights.device))
    return torch.einsum("bhqk,bkhd->bqhd", weights, value.to(dtype))


def mha_attention_fn(query, key, value, bias=None, mask=None,
                     broadcast_dropout: bool = True,
                     dropout_rng: Optional[torch.Generator] = None,
                     dropout_rate: float = 0.0, deterministic: bool = False,
                     dtype: Optional[torch.dtype] = None,
                     causal_hint: bool = False) -> torch.Tensor:
    """Attention of ``MultiHeadDotProductAttention`` (counterpart of
    ``mha_attention_fn``, ``ot_vae_tpu/networks/nets_utils.py:611``).

    Routed to the BTHD kernels (rows 7 and 8, :func:`fused_attention_bthd`)
    when the call has no bias, its mask is absent or the layer's causal hint
    with Tq = Tk, key and value share a shape, and dropout is off or
    broadcast (:func:`fused_attention_bthd_dropout`, the [Tq, Tk] keep mask
    drawn here as the plain path draws it). The kernels take every T and
    head dim: the JAX package's T ≥ 512 threshold and 128-lane windows were
    the TPU's, so its packed and BHTC fallbacks are never reached. Everything
    else takes :func:`dot_product_attention`. Dropout in train mode needs
    ``dropout_rng``: without it either route raises ``ValueError``.

    :param query: [B, Tq, H, d]; key, value: [B, Tk, H, d]
    :return: [B, Tq, H, d]
    """
    b, t, h, d = query.shape
    tk = key.shape[1]
    dropout_active = (not deterministic) and dropout_rate > 0.0
    causal = bool(causal_hint) and mask is not None and tk == t
    if (bias is None and (mask is None or causal)
            and key.shape == value.shape and key.shape[0] == b
            and tuple(key.shape[2:]) == (h, d)
            and (not dropout_active or broadcast_dropout)):
        dtype = dtype or query.dtype
        qf, kf, vf = (x.to(dtype).reshape(x.shape[0], x.shape[1], h * d)
                      for x in (query, key, value))
        scale = 1.0 / math.sqrt(d)
        if dropout_active:
            keep_prob = 1.0 - dropout_rate
            keep = dropout_keep((t, tk), keep_prob, dropout_rng, query.device)
            # keep_prob in the compute dtype first, as JAX rounds the scalar
            mult = keep.to(dtype) / torch.tensor(keep_prob, dtype=dtype, device=query.device)
            out = fused_attention_bthd_dropout(qf, kf, vf, mult, h, scale, causal=causal)
        else:
            out = fused_attention_bthd(qf, kf, vf, h, scale, causal=causal)
        return out.reshape(b, t, h, d)
    return dot_product_attention(query, key, value, bias=bias, mask=mask,
                                 broadcast_dropout=broadcast_dropout,
                                 dropout_rng=dropout_rng, dropout_rate=dropout_rate,
                                 deterministic=deterministic, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class KVCache:
    """One attention layer's decode cache, flax's ``cache`` collection:
    keys and values [B, T_max, H, d] and ``index``, the next position a
    single-token call writes."""

    key: torch.Tensor
    value: torch.Tensor
    index: int


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` with ``attention_fn`` =
    :func:`mha_attention_fn`: projections ``query``, ``key``, ``value``
    (kernels [dim, H, d], biases [H, d]) and ``out`` (kernel [H, d, dim],
    bias [dim]), d = dim / H. Attention dropout is off in eval mode; in
    train mode it draws from ``dropout_rng``.

    ``decode=True`` follows flax's KV cache with the state passed in and
    returned, ``(out, cache)``: without a ``cache`` the call attends as
    usual and returns a zeroed cache sized like its keys, index 0; with one,
    the call holds one token, writes its key and value at ``cache.index``,
    attends over the positions up to it (the plain attention, as flax's
    single-token calls take its stock path) and returns the cache advanced
    by one. The cache given is not changed.
    """

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0, causal_hint: bool = False):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        head_dim = dim // num_heads
        self.dropout_rate, self.causal_hint, self.dtype = dropout_rate, causal_hint, dtype
        self.query = _HeadProjection(dim, num_heads, head_dim, False, dtype)
        self.key = _HeadProjection(dim, num_heads, head_dim, False, dtype)
        self.value = _HeadProjection(dim, num_heads, head_dim, False, dtype)
        self.out = _HeadProjection(dim, num_heads, head_dim, True, dtype)

    def forward(self, inputs_q: torch.Tensor, inputs_kv: Optional[torch.Tensor] = None,
                mask=None, dropout_rng: Optional[torch.Generator] = None,
                decode: bool = False, cache: Optional[KVCache] = None):
        inputs_kv = inputs_q if inputs_kv is None else inputs_kv
        query, key, value = self.query(inputs_q), self.key(inputs_kv), self.value(inputs_kv)
        new_cache = None
        if decode and cache is None:
            new_cache = KVCache(torch.zeros_like(key), torch.zeros_like(value), 0)
        elif decode:
            b, t_max, h, d = cache.key.shape
            if tuple(query.shape) != (b, 1, h, d):
                raise ValueError(f"a cached decode call takes one token: query "
                                 f"{tuple(query.shape)}, expected {(b, 1, h, d)}")
            at = torch.tensor([cache.index], device=key.device)
            key = cache.key.index_copy(1, at, key.to(cache.key.dtype))
            value = cache.value.index_copy(1, at, value.to(cache.value.dtype))
            new_cache = KVCache(key, value, cache.index + 1)
            seen = (torch.arange(t_max, device=key.device) <= cache.index)[None, None, None]
            mask = seen if mask is None else mask.bool() & seen
        x = mha_attention_fn(query, key, value, mask=mask, dropout_rng=dropout_rng,
                             dropout_rate=self.dropout_rate,
                             deterministic=not self.training, dtype=self.dtype,
                             causal_hint=self.causal_hint)
        out = self.out(x)
        return (out, new_cache) if decode else out
