"""Generalized encoder/decoder ViT (counterpart: ``ot_vae_tpu/networks/vit.py``).

Token streams (input, embed, class) in the fixed order input|embed|class,
with the JAX package's static index bookkeeping (``_plan``), patchify and
unpatchify as reshapes, learned positional embeddings, post-LN transformer
blocks with an optional cross-attention stage (``preprocess_depth``).
Images are NHWC; ``out_size`` is (H, W, C) with ``embed_to_patch``, else
(tokens, dim). Module and parameter names follow the flax tree
(``TransformerLayer_0/MultiHeadDotProductAttention_0/query/kernel``, ...),
so ``convert.py`` carries variables across by path. Every attention call
goes through :func:`~ot_vae_tpu_torch.networks.nets_utils.mha_attention_fn`:
the BTHD kernels (rows 7 and 8) on a CUDA tensor.

Train mode (``module.training``) applies dropout where flax does: after the
positional embedding's LayerNorm (``emb_dropout``), and in each block on the
attention weights, after the attention, after the MLP's ReLU and after its
second Dense (``dropout``), each drawn from the generator that
``ViT.forward`` takes as ``dropout_rng``, in flax's order.

``causal_mask`` masks every self-attention causally (the layers' causal
hint, so rows 7 and 8 mask in the kernel); ``time_dependant`` appends a
trainable Gaussian Fourier ``time_token`` after the class token.
``decode=True`` is the KV-cached path of an autoregressive stack (causal,
no cross-attention, token embeddings in): it returns ``(out, caches)``, one
:class:`~ot_vae_tpu_torch.networks.nets_utils.KVCache` a layer. Without
``caches`` the call runs the causal forward and returns zeroed caches; with
them it takes one token at ``positions`` and returns the caches advanced.
The embed, class and time streams are left out there: they follow the input
tokens, so under the causal mask they never reach an input token's output.
:class:`AutoRegressive` adds the vocabulary embedding and the LM head.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ot_vae_tpu_torch.networks.nets_utils import (
    Dense,
    Dropout,
    Embed,
    GaussianFourierProjection,
    KVCache,
    LayerNorm,
    MultiHeadDotProductAttention,
)

__all__ = ["PositionalEmbedding", "TransformerLayer", "ViT", "AutoRegressive"]


def pair(t):
    return tuple(t) if isinstance(t, (tuple, list)) else (t, t)


class PositionalEmbedding(nn.Module):
    """Learned positional embedding, LayerNorm, then dropout in train mode."""

    def __init__(self, max_length: int, d_model: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model = d_model
        self.Embed_0 = Embed(max_length, d_model, dtype)
        self.LayerNorm_0 = LayerNorm(d_model, dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, dropout_rng: Optional[torch.Generator] = None,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``positions`` replaces the position ids ``arange(T)``: a cached
        decode call's one token sits at the position its caller tracks."""
        if x.shape[-1] != self.d_model:
            raise ValueError("feature dim of `x` must equal d_model")
        if positions is None:
            positions = torch.arange(x.shape[-2], device=x.device)
        pos = self.Embed_0(torch.as_tensor(positions, device=x.device))
        return self.dropout(self.LayerNorm_0(x + pos), dropout_rng)


class TransformerLayer(nn.Module):
    """Post-LN block: self-attention (+ optional cross-attention on
    ``memory``, Tq ≠ Tk) + ReLU MLP, each added to its input and normalised
    (torch ``nn.TransformerEncoderLayer``/``DecoderLayer`` semantics). In
    train mode dropout draws from ``dropout_rng`` in flax's order: attention
    weights, attention output, [cross-attention weights and output], ReLU
    output, MLP output."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, dropout: float = 0.0,
                 cross: bool = False, causal: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cross = cross
        self.dropout = Dropout(dropout)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            dim, heads, dtype, dropout, causal_hint=causal)
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        if cross:
            self.MultiHeadDotProductAttention_1 = MultiHeadDotProductAttention(
                dim, heads, dtype, dropout)
            self.LayerNorm_1 = LayerNorm(dim, dtype)
        self.Dense_0 = Dense(dim, mlp_dim, dtype)
        self.Dense_1 = Dense(mlp_dim, dim, dtype)
        setattr(self, f"LayerNorm_{2 if cross else 1}", LayerNorm(dim, dtype))

    def forward(self, x: torch.Tensor, memory: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                dropout_rng: Optional[torch.Generator] = None, decode: bool = False,
                cache: Optional[KVCache] = None):
        """The block's output; with ``decode``, ``(output, cache)`` as
        :class:`MultiHeadDotProductAttention` returns its cache."""
        drop = functools.partial(self.dropout, generator=dropout_rng)
        h = self.MultiHeadDotProductAttention_0(x, mask=mask, dropout_rng=dropout_rng,
                                                decode=decode, cache=cache)
        if decode:
            h, cache = h
        x = self.LayerNorm_0(x + drop(h))
        if self.cross:
            if memory is None:
                raise ValueError("cross-attention layer requires `memory`")
            h = self.MultiHeadDotProductAttention_1(x, memory, dropout_rng=dropout_rng)
            x = self.LayerNorm_1(x + drop(h))
        h = self.Dense_1(drop(F.relu(self.Dense_0(x))))
        final = self.LayerNorm_2 if self.cross else self.LayerNorm_1
        out = final(x + drop(h))
        return (out, cache) if decode else out


class ViT(nn.Module):
    """Generalized ViT with input, embed, class and time token streams.

    Arguments as the JAX ``ViT``; ``head_dim`` wins over ``heads`` when set.
    Forward: ``vit(x, labels=None, time=None, dropout_rng=None)`` on NHWC
    images (``patch_to_embed``) or [B, tokens, dim] embeddings; in train mode
    with a dropout rate above 0 ``dropout_rng`` (a ``torch.Generator`` on
    x's device) is required. ``decode``, ``positions`` and ``caches``: the
    KV-cached path (module docstring).
    """

    def __init__(self, image_size: Union[int, Tuple[int, int]], dim: int,
                 patch_size: Optional[Union[int, Tuple[int, int]]] = None, depth: int = 6,
                 preprocess_depth: Optional[int] = None, heads: int = 8,
                 head_dim: Optional[int] = None, mlp_dim: Optional[int] = None,
                 channels: int = 3, dropout: float = 0.1, emb_dropout: float = 0.0,
                 n_embed_tokens: Optional[int] = 1, n_input_tokens: Optional[int] = None,
                 output_tokens: Union[str, Sequence[str]] = "embed",
                 patch_to_embed: bool = True, embed_to_patch: bool = False,
                 num_classes: Optional[int] = None, time_dependant: bool = False,
                 causal_mask: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.time_dependant, self.causal_mask = time_dependant, causal_mask
        self.image_size, self.dim, self.patch_size = image_size, dim, patch_size
        self.depth, self.preprocess_depth, self.heads = depth, preprocess_depth, heads
        self.head_dim, self.channels = head_dim, channels
        self.n_embed_tokens, self.n_input_tokens = n_embed_tokens, n_input_tokens
        self.output_tokens, self.num_classes = output_tokens, num_classes
        self.patch_to_embed, self.embed_to_patch = patch_to_embed, embed_to_patch
        self.dtype = dtype
        self._plan = p = self._make_plan()
        mlp_dim = mlp_dim or dim * 4

        if patch_to_embed:
            self.patch_proj = Dense(p["patch_dim"], dim, dtype)
        if p["n_tokens"]["embed"] > 0:
            self.embed_token = nn.Parameter(torch.randn(1, p["n_tokens"]["embed"], dim))
        if num_classes is not None:
            self.class_token = Embed(num_classes, dim, dtype)
        if time_dependant:
            self.time_token = GaussianFourierProjection(dim, trainable=True, dtype=dtype)
        self.PositionalEmbedding_0 = PositionalEmbedding(p["total"], dim, emb_dropout, dtype)
        layers = []
        if preprocess_depth is not None:
            layers += [TransformerLayer(dim, self.n_heads, mlp_dim, dropout, dtype=dtype)
                       for _ in range(preprocess_depth)]
        layers += [TransformerLayer(dim, self.n_heads, mlp_dim, dropout,
                                    cross=preprocess_depth is not None, causal=causal_mask,
                                    dtype=dtype)
                   for _ in range(depth)]
        for i, layer in enumerate(layers):
            self.add_module(f"TransformerLayer_{i}", layer)
        self._layers = tuple(layers)  # a tuple registers nothing: the names stay flax's
        if embed_to_patch:
            self.unpatch_proj = Dense(dim, p["patch_dim"], dtype)
        self.register_buffer("_out_idx", torch.tensor(p["out_idx"]), persistent=False)
        self.register_buffer("_cross_idx", torch.tensor(p["cross_idx"], dtype=torch.long),
                             persistent=False)

    # -------------------------------------------------- static token plan

    @property
    def n_heads(self) -> int:
        if self.head_dim is None:
            return self.heads
        if self.dim % self.head_dim:
            raise ValueError(f"dim {self.dim} not divisible by head_dim {self.head_dim}")
        return self.dim // self.head_dim

    def _make_plan(self):
        image_h, image_w = pair(self.image_size)
        patch = self.patch_size
        if patch is None:
            patch = (min(image_h // 4, 16), min(image_w // 4, 16))
        patch_h, patch_w = pair(patch)
        if image_h % patch_h or image_w % patch_w:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        n_patch_h, n_patch_w = image_h // patch_h, image_w // patch_w
        num_patches = n_patch_h * n_patch_w
        n_tokens = {
            "input": num_patches if self.n_input_tokens is None else self.n_input_tokens,
            "embed": num_patches if self.n_embed_tokens is None else self.n_embed_tokens,
            "class": int(self.num_classes is not None),
            "time": int(self.time_dependant),
        }
        token_indices, cur = {}, 0
        for k, n in n_tokens.items():
            token_indices[k] = list(range(cur, cur + n))
            cur += n
        out_types = ([self.output_tokens] if isinstance(self.output_tokens, str)
                     else list(self.output_tokens))
        if not all(t in token_indices for t in out_types):
            raise ValueError(f"`output_tokens` must be within {list(token_indices)}")
        out_idx, cross_idx = [], []
        for k, idx in token_indices.items():
            (out_idx if k in out_types else cross_idx).extend(idx)
        return dict(image=(image_h, image_w), patch=(patch_h, patch_w),
                    n_patch=(n_patch_h, n_patch_w), num_patches=num_patches,
                    patch_dim=self.channels * patch_h * patch_w, n_tokens=n_tokens,
                    total=cur, out_idx=out_idx, cross_idx=cross_idx)

    @property
    def total_num_tokens(self) -> int:
        return self._plan["total"]

    @property
    def out_size(self) -> Tuple[int, ...]:
        p = self._plan
        if self.embed_to_patch:
            return (*p["image"], self.channels)
        return (len(p["out_idx"]), self.dim)

    # -------------------------------------------------- forward

    def _causal(self, n: int, device) -> Optional[torch.Tensor]:
        """The [1, 1, n, n] lower-triangular mask of a causal stack."""
        if not self.causal_mask:
            return None
        return torch.ones((n, n), dtype=torch.bool, device=device).tril()[None, None]

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                time: Optional[torch.Tensor] = None, decode: bool = False,
                positions: Optional[torch.Tensor] = None,
                caches: Optional[Sequence[KVCache]] = None,
                dropout_rng: Optional[torch.Generator] = None):
        if decode:
            return self._decode(x, positions, caches, dropout_rng)
        p = self._plan
        (ph, pw), (nh, nw) = p["patch"], p["n_patch"]
        b = x.shape[0]
        if self.patch_to_embed:  # b (h p1) (w p2) c -> b (h w) (p1 p2 c)
            x = x.reshape(b, nh, ph, nw, pw, self.channels).permute(0, 1, 3, 2, 4, 5)
            x = self.patch_proj(x.reshape(b, nh * nw, ph * pw * self.channels))
        streams = [x]
        if p["n_tokens"]["embed"] > 0:
            streams.append(self.embed_token.to(self.dtype).expand(b, -1, -1))
        if self.num_classes is not None:
            if labels is None:
                raise ValueError("`num_classes` set but `labels` is None")
            streams.append(self.class_token(labels)[:, None, :])
        if self.time_dependant:
            if time is None:
                raise ValueError("`time_dependant` set but `time` is None")
            streams.append(self.time_token(time)[:, None, :])
        # the streams meet in their promoted dtype, as jnp.concatenate does
        dtype = functools.reduce(torch.promote_types, [s.dtype for s in streams])
        x = self.PositionalEmbedding_0(torch.cat([s.to(dtype) for s in streams], dim=1),
                                       dropout_rng)

        layers = self._layers
        if self.preprocess_depth is None:
            mask = self._causal(x.shape[1], x.device)
            for layer in layers:
                x = layer(x, mask=mask, dropout_rng=dropout_rng)
            out = x[:, self._out_idx]
        else:
            memory = x[:, self._cross_idx]
            for layer in layers[:self.preprocess_depth]:
                memory = layer(memory, dropout_rng=dropout_rng)
            out = x[:, self._out_idx]
            mask = self._causal(out.shape[1], out.device)
            for layer in layers[self.preprocess_depth:]:
                out = layer(out, memory=memory, mask=mask, dropout_rng=dropout_rng)

        if self.embed_to_patch:  # b (h w) (p1 p2 c) -> b (h p1) (w p2) c
            out = self.unpatch_proj(out[:, -p["num_patches"]:])
            out = out.reshape(b, nh, nw, ph, pw, self.channels).permute(0, 1, 3, 2, 4, 5)
            out = out.reshape(b, nh * ph, nw * pw, self.channels)
        return out

    def _decode(self, x: torch.Tensor, positions, caches, dropout_rng):
        """The KV-cached path on token embeddings: ``(out, caches)``."""
        if not self.causal_mask or self.preprocess_depth is not None:
            raise ValueError("decode=True requires causal_mask=True and no "
                             "cross-attention preprocess stage")
        if self.patch_to_embed:
            raise ValueError("decode=True expects token embeddings, not images")
        x = self.PositionalEmbedding_0(x, dropout_rng, positions=positions)
        mask = self._causal(x.shape[1], x.device)
        caches = [None] * len(self._layers) if caches is None else list(caches)
        for i, layer in enumerate(self._layers):
            x, caches[i] = layer(x, mask=mask, dropout_rng=dropout_rng, decode=True,
                                 cache=caches[i])
        return x, caches


class AutoRegressive(ViT):
    """Token-level AR model: vocabulary embedding ``vocab_embed``, the ViT
    trunk on the embeddings, LM head ``lm_head`` → logits [B, T, vocab].
    With ``decode``, ``(logits, caches)``."""

    def __init__(self, *args, vocab_size: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        if vocab_size <= 0:
            raise ValueError("`vocab_size` must be set")
        self.vocab_size = vocab_size
        self.vocab_embed = Embed(vocab_size, self.dim, self.dtype)
        self.lm_head = Dense(self.dim, vocab_size, self.dtype)

    def forward(self, tokens: torch.Tensor, labels: Optional[torch.Tensor] = None,
                time: Optional[torch.Tensor] = None, decode: bool = False,
                positions: Optional[torch.Tensor] = None,
                caches: Optional[Sequence[KVCache]] = None,
                dropout_rng: Optional[torch.Generator] = None):
        hs = super().forward(self.vocab_embed(tokens), labels, time, decode, positions,
                             caches, dropout_rng)
        if decode:
            return self.lm_head(hs[0]), hs[1]
        return self.lm_head(hs)
