"""CNN encoder/decoder stack (counterpart: ``ot_vae_tpu/networks/cnn.py``).

``CNN`` takes and returns NHWC tensors, as the JAX package does
(``out_size`` is (H, W, C)); inside, tensors run NCHW in ``channels_last``
memory, so the 1×1 qkv conv's output viewed as [B, T, 3·H·C] is already the
packed layout the attention kernel reads. Module attribute names follow the
flax module tree (``ConvBlock_0``, ``ConvLayer_1``, ...), which is what
``convert.py`` relies on.

``embed_dim`` (the JAX ``additional_embed``) conditions every layer but the
skips' and the attention output's on an embedding [B, embed_dim]: FiLM
scale and bias from two ``EqualDense`` of act(embed), applied after the
norm. The ``AutoEncoder`` builds that embedding from its class and time
embeddings.

``fused_block=True`` (off by default, as in the JAX package) is the
counterpart of the JAX package's ``OT_VAE_FUSED_ATTN_BLOCK=1``: every
attention block with ``groups == 1`` runs its qkv projection, attention and
output projection as one fused block (rows 5 and 6 on the card), with the
same parameters.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ot_vae_tpu_torch.networks.nets_utils import (
    Embed,
    EqualConv,
    EqualDense,
    GaussianFourierProjection,
    Normalization,
    div_sqrt,
    get_activation,
    spatial_attention,
)
from ot_vae_tpu_torch.ops.attention import fused_attention_block

__all__ = ["ConvLayer", "Conv1x1", "AttentionBlock", "ConvBlock", "CNN", "AutoEncoder",
           "get_channel_list", "get_block_scaling"]


def _factor(flag: Union[bool, int]) -> int:
    if not flag:
        return 0
    return 2 if isinstance(flag, bool) else int(flag)


class ConvLayer(nn.Module):
    """norm → FiLM(embed) → act → upsample → conv (strided when
    downsampling). With ``embed_dim`` the FiLM scale and bias are
    ``EqualDense_0`` and ``EqualDense_1`` of act(embed)."""

    def __init__(self, in_features: int, features: int,
                 down_sample: Union[bool, int] = False,
                 up_sample: Union[bool, int] = False,
                 normalization: Optional[str] = None,
                 activation: Optional[str] = None,
                 equalized_lr: Optional[float] = None,
                 kernel_size: int = 3, groups: int = 1, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, embed_dim: Optional[int] = None):
        super().__init__()
        if not (in_features % groups == 0 and features % groups == 0):
            groups = 1
        self.act = get_activation(activation)
        self.Normalization_0 = Normalization(normalization, in_features, dtype)
        self.film = embed_dim is not None
        if self.film:
            lr = equalized_lr or 1.0
            self.EqualDense_0 = EqualDense(embed_dim, in_features, lr, dtype=dtype)
            self.EqualDense_1 = EqualDense(embed_dim, in_features, lr, dtype=dtype)
        kernel, stride = kernel_size, 1
        if down_sample:
            stride = _factor(down_sample)
            kernel = max(2 * stride, kernel)
        # a strided conv pads (1, 2) at kernel 4: nn.Conv2d's symmetric
        # padding cannot say that, so EqualConv pads explicitly
        pad = (((kernel - 1) // 2, kernel // 2) if stride > 1
               else ((kernel - 1) // 2, kernel - 1 - (kernel - 1) // 2))
        self.EqualConv_0 = EqualConv(
            in_features, features, kernel, stride, (pad, pad), groups,
            use_bias, equalized_lr, _factor(up_sample), dtype)

    def pre_conv(self, x: torch.Tensor, embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """What the conv reads: norm → FiLM → act."""
        out = self.Normalization_0(x)
        if self.film:
            if embed is None:
                raise ValueError("layer is embed-conditioned but `embed` is None")
            e = self.act(embed)
            scale, bias = self.EqualDense_0(e), self.EqualDense_1(e)
            out = out * scale[:, :, None, None] + bias[:, :, None, None]
        return self.act(out)

    def forward(self, x: torch.Tensor, embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.EqualConv_0(self.pre_conv(x, embed))


class Conv1x1(nn.Module):
    """Bias-free 1×1 conv, optionally normalized or resampled (skips, qkv)."""

    def __init__(self, in_features: int, features: int,
                 down_sample: Union[bool, int] = False,
                 up_sample: Union[bool, int] = False,
                 normalization: Optional[str] = None,
                 equalized_lr: Optional[float] = None, groups: int = 1,
                 dtype: torch.dtype = torch.float32, embed_dim: Optional[int] = None):
        super().__init__()
        self.ConvLayer_0 = ConvLayer(
            in_features, features, down_sample, up_sample, normalization, None,
            equalized_lr, 1, groups, False, dtype, embed_dim)

    def forward(self, x: torch.Tensor, embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.ConvLayer_0(x, embed)


class AttentionBlock(nn.Module):
    """Spatial self-attention: 1×1 qkv → multi-head attention → 1×1 proj.
    The projections stay PyTorch convs; the attention between them is the
    hand-written kernel on a CUDA tensor.

    With ``fused_block`` (and ``groups == 1``) the qkv conv's normalization
    runs alone and the two projections and the attention run as one fused
    block on the convs' effective weights (``fused_attention_block``: rows 5
    and 6 on a CUDA tensor), as the JAX block does under
    ``OT_VAE_FUSED_ATTN_BLOCK=1``. The parameters are the same either way.
    With ``embed_dim`` the qkv conv is FiLM-conditioned on the embedding, on
    both paths.
    """

    def __init__(self, channels: int, heads: int = 1,
                 normalization: Optional[str] = None,
                 equalized_lr: Optional[float] = None, groups: int = 1,
                 dtype: torch.dtype = torch.float32, fused_block: bool = False,
                 embed_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.fused_block = fused_block and groups == 1
        self.Conv1x1_0 = Conv1x1(channels, channels * 3, normalization=normalization,
                                 equalized_lr=equalized_lr, groups=groups, dtype=dtype,
                                 embed_dim=embed_dim)
        self.Conv1x1_1 = Conv1x1(channels, channels, equalized_lr=equalized_lr,
                                 groups=groups, dtype=dtype)

    def forward(self, x: torch.Tensor, embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.fused_block:
            return self._fused(x, embed)
        b, c, h, w = x.shape
        # channels_last NCHW → [B, T, 3·C] is a view, not a copy
        qkv = self.Conv1x1_0(x, embed).permute(0, 2, 3, 1).reshape(b, h * w, 3 * c)
        out = spatial_attention(qkv, self.heads)
        return self.Conv1x1_1(out.view(b, h, w, c).permute(0, 3, 1, 2))

    def _fused(self, x: torch.Tensor, embed: Optional[torch.Tensor]) -> torch.Tensor:
        b, c, h, w = x.shape
        layer = self.Conv1x1_0.ConvLayer_0
        normed = layer.pre_conv(x, embed)
        # the OIHW [3C, C, 1, 1] and [C, C, 1, 1] effective weights viewed
        # as the [C, 3C] and [C, C] matrices the block multiplies by: the
        # transposed views the kernels read through their strides
        w_qkv = layer.EqualConv_0.effective_params()[0].view(3 * c, c).t()
        w_out = self.Conv1x1_1.ConvLayer_0.EqualConv_0.effective_params()[0].view(c, c).t()
        # channels_last NCHW → [B, T, C] is a view, not a copy
        tokens = normed.permute(0, 2, 3, 1).reshape(b, h * w, c)
        out = fused_attention_block(tokens, w_qkv, w_out, self.heads)  # scale 1/sqrt(ch)
        return out.view(b, h, w, c).permute(0, 3, 1, 2)


class ConvBlock(nn.Module):
    """Resampling layer + (n_layers-1) fixed layers + optional attention,
    with a residual add/cat through a 1×1 skip."""

    def __init__(self, in_features: int, features: int, n_attn_heads: int = 0,
                 n_layers: int = 2, down_sample: Union[bool, int] = False,
                 up_sample: Union[bool, int] = False,
                 normalization: Optional[str] = "batchnorm",
                 activation: Optional[str] = "relu",
                 residual: Optional[str] = None,
                 equalized_lr: Optional[float] = None, kernel_size: int = 3,
                 groups: int = 1, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, fused_block: bool = False,
                 embed_dim: Optional[int] = None):
        super().__init__()
        self.residual = residual
        self.n_layers = n_layers
        embed = features // 2 if residual == "cat" else features
        for i in range(n_layers):
            setattr(self, f"ConvLayer_{i}", ConvLayer(
                in_features if i == 0 else embed, embed,
                down_sample if i == 0 else False, up_sample if i == 0 else False,
                normalization, activation, equalized_lr, kernel_size, groups,
                use_bias, dtype, embed_dim))
        self.AttentionBlock_0 = (AttentionBlock(
            embed, n_attn_heads, normalization, equalized_lr, groups, dtype, fused_block,
            embed_dim)
            if n_attn_heads > 0 else None)
        self.Conv1x1_0 = (Conv1x1(
            in_features, embed, down_sample, up_sample, normalization,
            equalized_lr, groups, dtype)
            if residual in ("cat", "add") else None)

    def forward(self, x: torch.Tensor, embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = x
        for i in range(self.n_layers):
            out = getattr(self, f"ConvLayer_{i}")(out, embed)
        if self.AttentionBlock_0 is not None:
            out = out + self.AttentionBlock_0(out, embed)
        if self.Conv1x1_0 is None:
            return out
        skip = self.Conv1x1_0(x)
        if self.residual == "cat":
            return torch.cat([out, skip], dim=1)
        return out + skip


def get_block_scaling(max_resolution: int, min_resolution: int,
                      max_scaling: int) -> List[int]:
    """Per-block scaling factors from high to low resolution.
    get_block_scaling(64, 2, 4) → [4, 4, 2]."""
    log_res_ratio = int(math.log2(max_resolution // min_resolution))
    log_scale = int(math.log2(max_scaling))
    mapping: List[int] = []
    while log_res_ratio > 0:
        mapping.extend([int(2**log_scale)] * (log_res_ratio // log_scale))
        log_res_ratio %= log_scale
        log_scale -= 1
    return mapping


def get_channel_list(in_features: int, out_features: int, in_resolution: int,
                     out_resolution: int, scaling_factor: int,
                     capacity: int) -> Tuple[List[int], List[int]]:
    """Channels double per block as the resolution drops."""
    factors = get_block_scaling(in_resolution, out_resolution, scaling_factor)
    features = [max(min(2**i * capacity, out_features), in_features)
                for i, _ in enumerate(factors)]
    resolutions = [in_resolution]
    for sf in factors:
        resolutions.append(resolutions[-1] // sf)
    features[-1] = out_features
    return [in_features] + features, resolutions


def _plan_cnn(in_features, out_features, in_resolution, out_resolution,
              intermediate_features, capacity, max_attn_res, down_sample,
              up_sample):
    """The block plan: (features list, attention resolution of each block)."""
    if bool(up_sample) and bool(down_sample):
        raise ValueError("Both `up_sample` and `down_sample` are set.")
    if intermediate_features is not None:
        features = [in_features] + list(intermediate_features) + [out_features]
        return features, [max_attn_res + 1] * len(features)
    if not (in_resolution and out_resolution and (bool(up_sample) or bool(down_sample))):
        raise ValueError(
            "Set `in_resolution`, `out_resolution` and (`up_sample` or `down_sample`)"
            " to infer the block plan, or pass `intermediate_features`.")
    if bool(down_sample):
        if in_resolution <= out_resolution:
            raise ValueError("`down_sample` set but `in_resolution` <= `out_resolution`")
        features, resolutions = get_channel_list(
            in_features, out_features, in_resolution, out_resolution,
            _factor(down_sample), capacity)
        return features, resolutions[1:]
    if out_resolution <= in_resolution:
        raise ValueError("`up_sample` set but `out_resolution` <= `in_resolution`")
    features, resolutions = get_channel_list(
        out_features, in_features, out_resolution, in_resolution,
        _factor(up_sample), capacity)
    return features[::-1], resolutions[::-1][:-1]


class CNN(nn.Module):
    """Stack of ConvBlocks on the auto channel/resolution schedule.
    Takes and returns NHWC; ``out_size`` = (H, W, C). Train and eval mode
    follow ``module.training`` (the batch norms read it). ``embed_dim``:
    the width of the FiLM embedding ``forward`` then takes."""

    def __init__(self, in_features: int, out_features: int,
                 in_resolution: Optional[int] = None,
                 out_resolution: Optional[int] = None,
                 intermediate_features: Optional[Sequence[int]] = None,
                 capacity: int = 8, max_attn_res: int = 16, n_layers: int = 2,
                 residual: Optional[str] = None,
                 down_sample: Union[bool, int] = False,
                 up_sample: Union[bool, int] = False,
                 normalization: Optional[str] = "batchnorm",
                 activation: Optional[str] = "relu",
                 equalized_lr: Optional[float] = None, kernel_size: int = 3,
                 groups: int = 1, use_bias: bool = True,
                 attn_head_dim: Optional[int] = None, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, fused_block: bool = False,
                 embed_dim: Optional[int] = None):
        super().__init__()
        if dropout > 0:
            raise NotImplementedError(
                "dropout > 0: the CNN dropout draw arrives with slice 9 (ROADMAP)")
        self.out_size = (out_resolution, out_resolution, out_features)
        features, attn_res = _plan_cnn(
            in_features, out_features, in_resolution, out_resolution,
            intermediate_features, capacity, max_attn_res, down_sample, up_sample)
        self.n_blocks = len(features) - 1
        for bi, (ic, oc, r) in enumerate(zip(features[:-1], features[1:], attn_res)):
            if r > max_attn_res:
                heads = 0
            elif attn_head_dim and oc % attn_head_dim == 0:
                heads = max(1, oc // attn_head_dim)
            else:
                heads = div_sqrt(oc)
            setattr(self, f"ConvBlock_{bi}", ConvBlock(
                ic, oc, heads, n_layers, down_sample, up_sample, normalization,
                activation, residual, equalized_lr, kernel_size, groups,
                use_bias, dtype, fused_block, embed_dim))

    def forward(self, x: torch.Tensor, embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC → NCHW view, channels_last memory
        for bi in range(self.n_blocks):
            x = getattr(self, f"ConvBlock_{bi}")(x, embed)
        return x.permute(0, 2, 3, 1)


class AutoEncoder(nn.Module):
    """Encoder and decoder CNN pair (counterpart: ``AutoEncoder``,
    ``ot_vae_tpu/networks/cnn.py``). ``latent_size`` = (H, W, C); with
    ``double_encoded_features`` the encoder emits twice the latent channels
    (a prior's mean and log-variance).

    ``num_classes`` adds ``class_embed`` (an ``Embed`` of width
    2^(floor(log10 num_classes) + 5)) and ``time_embed_dim`` adds
    ``time_embed`` (a Gaussian Fourier projection of t with three Dense
    layers); their concatenation, class first, FiLM-conditions every layer
    of both CNNs. ``encode``, ``decode`` and ``forward`` then take
    ``labels`` and ``time``."""

    def __init__(self, in_features: int, latent_features: int,
                 in_resolution: Optional[int] = None,
                 latent_resolution: Optional[int] = None,
                 intermediate_features: Optional[Sequence[int]] = None,
                 capacity: int = 8, max_attn_res: int = 16,
                 num_classes: Optional[int] = None,
                 time_embed_dim: Optional[int] = None,
                 double_encoded_features: bool = False, n_layers: int = 2,
                 residual: Optional[str] = None,
                 down_up_sample: Union[bool, int] = False,
                 normalization: Optional[str] = "batchnorm",
                 activation: Optional[str] = "relu",
                 equalized_lr: Optional[float] = None, dropout: float = 0.0,
                 kernel_size: int = 3, groups: int = 1, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, fused_block: bool = False):
        super().__init__()
        self.num_classes, self.time_embed_dim = num_classes, time_embed_dim
        self.latent_features = latent_features
        self.double_encoded_features = double_encoded_features
        encoded = latent_features * (1 + int(double_encoded_features))
        self.latent_size = (latent_resolution, latent_resolution, encoded)
        dims = []
        if num_classes:
            dims.append(2 ** (int(math.log10(num_classes)) + 5))
            self.class_embed = Embed(num_classes, dims[-1], dtype)
        if time_embed_dim:
            dims.append(time_embed_dim)
            self.time_embed = GaussianFourierProjection(time_embed_dim, time_embed_dim,
                                                        dtype=dtype)
        common = dict(capacity=capacity, max_attn_res=max_attn_res, n_layers=n_layers,
                      residual=residual, normalization=normalization,
                      activation=activation, equalized_lr=equalized_lr,
                      kernel_size=kernel_size, groups=groups, use_bias=use_bias,
                      dropout=dropout, dtype=dtype, fused_block=fused_block,
                      embed_dim=sum(dims) if dims else None)
        self.encoder = CNN(in_features, encoded, in_resolution, latent_resolution,
                           intermediate_features, down_sample=down_up_sample, **common)
        self.decoder = CNN(latent_features, in_features, latent_resolution, in_resolution,
                           None if intermediate_features is None
                           else list(intermediate_features)[::-1],
                           up_sample=down_up_sample, **common)

    def embed(self, labels: Optional[torch.Tensor] = None,
              time: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
        """The joint class and time embedding [B, embed_dim], or None."""
        parts = []
        if self.num_classes:
            if labels is None:
                raise ValueError("`num_classes` set but `labels` is None")
            parts.append(self.class_embed(labels))
        if self.time_embed_dim:
            if time is None:
                raise ValueError("`time_embed_dim` set but `time` is None")
            parts.append(self.time_embed(time))
        if not parts:
            return None
        return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]

    def encode(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
               time: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.encoder(x, self.embed(labels, time))

    def decode(self, z: torch.Tensor, labels: Optional[torch.Tensor] = None,
               time: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decoder(z, self.embed(labels, time))

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                time: Optional[torch.Tensor] = None) -> torch.Tensor:
        z = self.encode(x, labels, time)
        if self.double_encoded_features:
            z = z[..., :self.latent_features]  # the mean half
        return self.decode(z, labels, time)
