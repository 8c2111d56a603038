"""Loggers (counterpart: ``ot_vae_tpu/trainer/loggers.py``). A logger has
``log_metrics(dict, step)``. The CSV, TensorBoard and W&B loggers come with
slice 9."""
from __future__ import annotations

from typing import Dict

__all__ = ["PrintLogger"]


class PrintLogger:
    def log_metrics(self, metrics: Dict[str, float], step: int):
        msg = "  ".join(f"{k}={float(v):.4g}" for k, v in metrics.items())
        print(f"[step {step}] {msg}", flush=True)
