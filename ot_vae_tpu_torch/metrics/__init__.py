"""Streaming metrics (counterpart: ``ot_vae_tpu/metrics/__init__.py``).

A metric is a config object with functions over a state of tensors::

    init(device) -> state
    update(state, **batch) -> state
    compute(state) -> scalar tensor

``batch`` carries ``preds`` and ``target`` (and, in later slices, the keys
FID reads). States stay on the device; only ``compute`` is read back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

__all__ = ["Metric", "PSNR", "MetricCollection"]


class Metric:
    def init(self, device=None):
        raise NotImplementedError

    def update(self, state, **batch):
        raise NotImplementedError

    def compute(self, state) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PSNR(Metric):
    """Peak signal-to-noise ratio; when ``data_range`` is None it is the
    observed target range (torchmetrics' default, as the JAX metric)."""

    data_range: Optional[float] = None

    def init(self, device=None) -> Dict[str, torch.Tensor]:
        def scalar(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return {"sse": scalar(0.0), "n": scalar(0.0), "data_min": scalar(math.inf),
                "data_max": scalar(-math.inf)}

    def update(self, state, preds=None, target=None, **_):
        if preds is None or target is None:
            return state
        target = target.float()
        return {
            "sse": state["sse"] + torch.sum((preds.float() - target) ** 2),
            "n": state["n"] + float(target.numel()),
            "data_min": torch.minimum(state["data_min"], target.min()),
            "data_max": torch.maximum(state["data_max"], target.max()),
        }

    def compute(self, state) -> torch.Tensor:
        rng = (self.data_range if self.data_range is not None
               else state["data_max"] - state["data_min"])
        mse = state["sse"] / torch.clamp_min(state["n"], 1.0)
        return 10.0 * torch.log10(rng ** 2 / torch.clamp_min(mse, 1e-12))


@dataclasses.dataclass(frozen=True)
class MetricCollection:
    """Named metrics updated together, results keyed ``prefix + name``."""

    metrics: Dict[str, Metric]
    prefix: str = ""

    def clone(self, prefix: str) -> "MetricCollection":
        return MetricCollection(dict(self.metrics), prefix)

    def init(self, device=None):
        return {name: m.init(device) for name, m in self.metrics.items()}

    def update(self, states, **batch):
        return {name: self.metrics[name].update(states[name], **batch)
                for name in self.metrics}

    def compute(self, states) -> Dict[str, torch.Tensor]:
        return {self.prefix + name: self.metrics[name].compute(states[name])
                for name in self.metrics}
