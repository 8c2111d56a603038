"""Helpers the port needs, as its own copies
(counterparts in ``ot_vae_tpu/utils/__init__.py``)."""
from __future__ import annotations

import math
import re
from typing import List, Optional, Sequence, Tuple, Union

import torch

__all__ = ["unsqueeze_like", "replicate_batch", "mean_replicated_batch",
           "std_replicated_batch", "ema", "laplace_smoothing", "permute_and_flatten",
           "unflatten_and_unpermute", "camel2snake", "resolve_device"]


def unsqueeze_like(tensor: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Append singleton dims to ``tensor`` until it matches ``like``'s rank."""
    n = like.dim() - tensor.dim()
    if n < 0:
        raise ValueError(f"tensor.ndim={tensor.dim()} > like.ndim={like.dim()}")
    return tensor[(...,) + (None,) * n] if n else tensor


def replicate_batch(batch: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    """Tile the batch n× along the leading dim (multi-sample expansion)."""
    if n in (0, 1) or batch is None:
        return batch
    return batch.repeat(n, *([1] * (batch.dim() - 1)))


def mean_replicated_batch(expanded: torch.Tensor, n: int) -> torch.Tensor:
    """Mean over the n replicas of a :func:`replicate_batch` expansion."""
    if n in (0, 1):
        return expanded
    return expanded.reshape(n, expanded.shape[0] // n, *expanded.shape[1:]).mean(0)


def std_replicated_batch(expanded: torch.Tensor, n: int) -> torch.Tensor:
    """Population std (numpy's ddof=0) over the n replicas."""
    if n in (0, 1):
        return expanded
    return expanded.reshape(n, expanded.shape[0] // n, *expanded.shape[1:]).std(
        0, unbiased=False)


def ema(moving_avg, new, decay: Optional[float]):
    """EMA merge; plain accumulation when ``decay`` is None."""
    if decay is None:
        return moving_avg + new
    return moving_avg * decay + new * (1.0 - decay)


def laplace_smoothing(x: torch.Tensor, n_categories: int,
                      eps: Optional[float] = 1e-5) -> torch.Tensor:
    """Additive smoothing over the last dim that keeps the total mass."""
    if eps is None:
        return x
    total = x.sum(dim=-1, keepdim=True)
    return (x + eps) / (total + n_categories * eps) * total


def _split_dims(ndim: int, permute_dims: Sequence[int]) -> Tuple[List[int], List[int]]:
    all_dims = set(range(1, ndim))
    if not permute_dims:
        raise ValueError("`permute_dims` must contain at least one dimension")
    if not set(permute_dims).issubset(all_dims):
        raise ValueError("`permute_dims` must be a subset of the input dims")
    return sorted(all_dims.difference(permute_dims)), list(permute_dims)


def permute_and_flatten(x: torch.Tensor, permute_dims: Sequence[int],
                        batch_first: bool = True,
                        flatten_batch: bool = False) -> torch.Tensor:
    """Move ``permute_dims`` last and flatten them into one event dim; the
    other non-batch dims flatten into an operator-batch dim.

    x [B, d1, ..., dn] → [B, prod(rest), prod(permute)] (``batch_first``),
    [prod(rest), B, prod(permute)] (not ``batch_first``), or
    [B·prod(rest), prod(permute)] (``flatten_batch``).
    """
    remaining, permute_dims = _split_dims(x.dim(), permute_dims)
    event = math.prod(x.shape[d] for d in permute_dims)
    if not remaining:
        return x.reshape(-1, event) if flatten_batch else x.reshape(x.shape[0], -1)
    rest = math.prod(x.shape[d] for d in remaining)
    if batch_first:
        xr = x.permute(0, *remaining, *permute_dims).reshape(x.shape[0], rest, event)
    else:
        xr = x.permute(*remaining, 0, *permute_dims).reshape(rest, x.shape[0], event)
    return xr.reshape(-1, event) if flatten_batch else xr


def unflatten_and_unpermute(xr: torch.Tensor, orig_shape: Sequence[int],
                            permute_dims: Sequence[int], batch_first: bool = True,
                            flatten_batch: bool = False) -> torch.Tensor:
    """Inverse of :func:`permute_and_flatten`; ``orig_shape`` may hold -1
    for the batch dim."""
    orig_shape = list(orig_shape)
    ndim = len(orig_shape)
    remaining, permute_dims = _split_dims(ndim, permute_dims)
    permute_shape = [orig_shape[d] for d in permute_dims]
    remaining_shape = [orig_shape[d] for d in remaining]
    if not remaining:
        return xr.reshape(*orig_shape)
    x = xr
    if flatten_batch:
        n_rem = math.prod(remaining_shape)
        x = x.reshape(*((-1, n_rem) if batch_first else (n_rem, -1)), x.shape[-1])
    if batch_first:
        x = x.reshape(-1, *remaining_shape, *permute_shape)
    else:
        x = x.reshape(*remaining_shape, -1, *permute_shape)
    perm = [0] * ndim
    lead = 1 if batch_first else 0
    perm[0] = 0 if batch_first else len(remaining)
    for i, d in enumerate(remaining):
        perm[d] = lead + i
    for i, d in enumerate(permute_dims):
        perm[d] = len(remaining) + 1 + i
    return x.permute(*perm)


def camel2snake(name: str) -> str:
    return name[0].lower() + re.sub(r"(?!^)[A-Z]", lambda m: "_" + m.group(0).lower(),
                                    name[1:])


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on. A CUDA device must exist: an entry
    point never continues on the CPU unless the caller asked for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device
