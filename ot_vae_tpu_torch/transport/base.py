"""Transport operators (counterpart: ``ot_vae_tpu/transport/base.py``): a
frozen config with ``init``, ``update``, ``compute`` and ``transport``
functions over a state of tensors, as in the JAX package."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["TransportOperator"]


@dataclasses.dataclass(frozen=True)
class TransportOperator:
    """Base of the operators: a source and a target distribution model and
    the map between them. Single process: the cross-device sums of the JAX
    package arrive with multi-GPU (slice 9)."""

    leading_shape: Tuple[int, ...] = ()
    dim: int = 1
    reset_source: bool = True
    reset_target: bool = True
    store_source: bool = False
    store_target: bool = False

    def init(self, generator: torch.Generator):
        """A fresh state on the generator's device."""
        raise NotImplementedError

    def reset(self, state, generator: torch.Generator):
        """Re-initialise the sides flagged for reset."""
        fresh = self.init(generator)
        return state.replace(
            **({"source": fresh.source} if self.reset_source else {}),
            **({"target": fresh.target} if self.reset_target else {}))

    def update(self, state, source_samples: Optional[torch.Tensor] = None,
               target_samples: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """Feed samples into either side."""
        raise NotImplementedError

    def compute(self, state, source_samples: Optional[torch.Tensor] = None,
                target_samples: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Fit both sides and the operator: (new state, transport cost [*L])."""
        raise NotImplementedError

    def transport(self, state, inputs: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Map source samples onto the target distribution."""
        raise NotImplementedError
