"""Prior contract (counterpart: ``ot_vae_tpu/priors/base.py``).

A prior is an ``nn.Module`` with::

    forward(x, generator=None, noise=None, **cond) -> z
    sample(shape, generator=None, device=None, **cond) -> z
    out_size(size) -> size

Serving needs only the draw; the prior losses and their warm-up come with
the training slice.
"""
from __future__ import annotations

from torch import nn

__all__ = ["PriorModule"]


class PriorModule(nn.Module):
    """Base class of the port's priors."""
