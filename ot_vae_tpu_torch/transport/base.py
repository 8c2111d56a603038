"""Transport operators (counterpart: ``ot_vae_tpu/transport/base.py``): a
frozen config with ``init``, ``update``, ``compute`` and ``transport``
functions over a state of tensors, as in the JAX package, and the layout
of the operators' state files."""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["TransportOperator", "OperatorState"]


def _leaves(state, prefix: str = "") -> Dict[str, np.ndarray]:
    """A dataclass state's leaves as numpy arrays by dotted field name; a
    field that is None has no leaf."""
    out = {}
    for f in dataclasses.fields(state):
        value, name = getattr(state, f.name), prefix + f.name
        if value is None:
            continue
        if dataclasses.is_dataclass(value):
            out.update(_leaves(value, name + "."))
        elif torch.is_tensor(value):
            out[name] = value.detach().cpu().numpy()
        else:
            out[name] = np.asarray(value)
    return out


def _rebuild(template, arrays: Mapping[str, np.ndarray], device, prefix: str = ""):
    """``template``'s dataclass structure with its leaves read from
    ``arrays``: tensors in the template's dtype on ``device``, Python bools
    as bools."""
    values = {}
    for f in dataclasses.fields(template):
        value, name = getattr(template, f.name), prefix + f.name
        if value is None:
            values[f.name] = None
        elif dataclasses.is_dataclass(value):
            values[f.name] = _rebuild(value, arrays, device, name + ".")
        elif torch.is_tensor(value):
            array = np.array(arrays[name], dtype=value.cpu().numpy().dtype)
            values[f.name] = torch.as_tensor(array, device=device)
        else:
            values[f.name] = type(value)(arrays[name])
    return type(template)(**values)


class OperatorState:
    """Mixin of the operators' frozen dataclass states: ``replace`` and the
    flat layout of the state files (``source.n``, ..., ``plan``)."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Leaves as numpy arrays by dotted name; optional fields that are
        None (the Gaussian's Kahan buffers without compensation) have none."""
        return _leaves(self)

    @classmethod
    def from_arrays(cls, arrays: Mapping[str, np.ndarray], template, device):
        """A state with ``template``'s structure from arrays by name (the
        layout of :meth:`to_arrays`) on ``device``; a missing, extra or
        reshaped leaf raises."""
        want = template.to_arrays()
        if set(arrays) != set(want):
            raise ValueError(f"state leaves {sorted(arrays)} do not match the operator's "
                             f"{sorted(want)}")
        for name, value in want.items():
            if np.shape(arrays[name]) != value.shape:
                raise ValueError(f"state leaf {name} has shape {np.shape(arrays[name])}, "
                                 f"the operator expects {value.shape}")
        return _rebuild(template, arrays, device)


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
