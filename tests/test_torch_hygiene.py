"""The port stands alone: no file of ot_vae_tpu_torch/ or chip_smoke.py
imports JAX, flax, yaml or the JAX package, and its entry points do not
continue on the CPU when the card is missing."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "yaml", "ot_vae_tpu"}
PORT_FILES = sorted((ROOT / "ot_vae_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    assert not set(_imported_roots(path)) & FORBIDDEN


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ot_vae_tpu_torch\n"
        "for m in pkgutil.walk_packages(ot_vae_tpu_torch.__path__, 'ot_vae_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from ot_vae_tpu_torch.models import VAE
    from ot_vae_tpu_torch.networks import CNN
    from ot_vae_tpu_torch.priors import GaussianPrior
    from ot_vae_tpu_torch.serving import InferenceEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = VAE(CNN(3, 4, 8, 4, capacity=4, down_sample=True),
                CNN(2, 3, 4, 8, capacity=4, up_sample=True), GaussianPrior())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(model)


def test_trainer_and_checkpoint_engine_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path):
    from ot_vae_tpu_torch.models import VAE
    from ot_vae_tpu_torch.networks import CNN
    from ot_vae_tpu_torch.priors import GaussianPrior
    from ot_vae_tpu_torch.serving import InferenceEngine
    from ot_vae_tpu_torch.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer()
    model = VAE(CNN(3, 4, 8, 4, capacity=4, down_sample=True),
                CNN(2, 3, 4, 8, capacity=4, up_sample=True), GaussianPrior())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(model, checkpoint_path=str(tmp_path / "ckpt"))
