"""Helpers the port needs, as its own copies
(counterparts in ``ot_vae_tpu/utils/__init__.py``)."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["unsqueeze_like", "replicate_batch", "mean_replicated_batch",
           "std_replicated_batch", "ema", "resolve_device"]


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


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on. A CUDA device must exist: an entry
    point never continues on the CPU unless the caller asked for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device
