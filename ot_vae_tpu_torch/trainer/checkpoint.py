"""Checkpoints (counterpart: ``save_checkpoint``/``load_checkpoint`` in
``ot_vae_tpu/trainer/checkpoint.py``).

A checkpoint is a directory holding ``checkpoint.pt`` (``torch.save`` of
the step, the net's state dict, the optimizer state and the EMA copy) and
``sidecar.json`` (metadata and the model's inference transforms as JSON
specs), so a restored model takes raw images. The JAX package's Orbax
checkpoints are not read. Partial checkpoints come with slice 9.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import torch

from ot_vae_tpu_torch.data.transforms import from_spec, to_spec

__all__ = ["save_checkpoint", "load_checkpoint"]

STATE_FILE = "checkpoint.pt"
SIDECAR_FILE = "sidecar.json"


def save_checkpoint(path, state, model=None, metadata: Optional[dict] = None):
    """Write ``state`` (a ``TrainState``) and the sidecar into directory ``path``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    torch.save(state.state_dict(), path / STATE_FILE)
    side = dict(metadata or {})
    if model is not None:
        side["inference_preprocess"] = to_spec(model.inference_preprocess)
        side["inference_postprocess"] = to_spec(model.inference_postprocess)
    with open(path / SIDECAR_FILE, "w") as f:
        json.dump(side, f)


def load_checkpoint(path, model=None) -> Tuple[dict, dict]:
    """Read a checkpoint directory: (state tree on the CPU, sidecar). With
    ``model``, load its net's state dict (strict) and inference transforms."""
    path = Path(path)
    tree = torch.load(path / STATE_FILE, map_location="cpu", weights_only=True)
    side = {}
    if (path / SIDECAR_FILE).exists():
        with open(path / SIDECAR_FILE) as f:
            side = json.load(f)
    if model is not None:
        model.net.load_state_dict(tree["model"], strict=True)
        if "inference_preprocess" in side:
            model.inference_preprocess = from_spec(side["inference_preprocess"])
        if "inference_postprocess" in side:
            model.inference_postprocess = from_spec(side["inference_postprocess"])
    return tree, side
