#!/usr/bin/env python3
"""The seeded model gates of chip_smoke.py over many initial weights, on the
card: how each gate's reading spreads over the weights' seed, to choose how
chip_smoke.py holds its floor.

    python scripts/gate_spread.py --gates mnist32 auto_diffusion dad --seeds 0 1 2 3 4 5

``mnist32`` is phase 12's run (the latent-transport gate: restored PSNR of
the Gaussian, GMM and discrete operators) and ``dad`` phase 29's (test
PSNR), each on the weights ``torch.manual_seed(seed)`` draws and the gate's
trainer seed; ``auto_diffusion`` is phase 28's (test PSNR) on the JAX gate's
own initial weights with ``seed`` as the trainer seed. Each run is
chip_smoke.py's own, with its checks of losses and launches; a run whose
checks fail is reported and the others go on. The script prints each run's
reading, then, per gate, the readings in seed order, their median and the
medians of each window of 3 and 5 consecutive seeds. Needs one card.
"""
from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _windows(values, n):
    return [round(statistics.median(values[i:i + n]), 3) for i in range(len(values) - n + 1)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gates", nargs="+", default=["mnist32", "auto_diffusion", "dad"],
                   choices=["mnist32", "auto_diffusion", "dad"])
    p.add_argument("--seeds", type=int, nargs="+", default=list(range(6)))
    a = p.parse_args(argv)

    import torch

    import chip_smoke as cs
    from ot_vae_tpu_torch.data import MNIST, MNIST32
    from ot_vae_tpu_torch.ops import _build, attention, sinkhorn

    print(cs.nvidia_smi(), flush=True)
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workdir = ROOT / "build" / "gate_spread"
    readings = {}

    def record(name, seed, fn):
        try:
            value = fn()
        except cs.CheckFailed as e:
            print(f"{name}, seed {seed}: check failed: {e}", flush=True)
            value = (dict.fromkeys(("gaussian", "gmm", "discrete"), float("nan"))
                     if name == "mnist32" else float("nan"))
        if isinstance(value, dict):
            for k, v in value.items():
                readings.setdefault(f"{name} {k}", []).append(float(v))
        else:
            readings.setdefault(name, []).append(float(value))

    if "mnist32" in a.gates:
        dm = MNIST32(train_batch_size=50, val_batch_size=50, test_batch_size=50, seed=42,
                     synthetic_train=2500, synthetic_test=2200, test_val_split=0.9)
        dm.setup()
        for s in a.seeds:
            record("mnist32", s, lambda: cs._mnist32_gate_run(dm, s, sinkhorn)[2])
    if "auto_diffusion" in a.gates:
        dm = MNIST32(train_batch_size=50, val_batch_size=50, test_batch_size=50, seed=42,
                     synthetic_train=3000, synthetic_test=500)
        dm.setup()

        def counts():
            return (attention.launch_count, attention.backward_launch_count,
                    attention.bthd_launch_count + attention.bthd_bwd_launch_count)

        for s in a.seeds:
            record("auto_diffusion", s,
                   lambda: cs._auto_diffusion_gate_run(attention, dm, s, counts, workdir)[1])
    if "dad" in a.gates:
        dm = MNIST(train_batch_size=50, val_batch_size=50, test_batch_size=50, seed=42,
                   synthetic_train=2500, synthetic_test=600)
        dm.setup()
        for s in a.seeds:
            record("dad", s, lambda: cs._dad_gate_run(attention, dm, s, workdir)[1])

    for name, values in readings.items():
        print(f"spread {name}: seeds {a.seeds}: {[round(v, 3) for v in values]}; median "
              f"{statistics.median(values):.3f} dB; medians of 3 consecutive seeds "
              f"{_windows(values, 3)}; of 5 {_windows(values, 5)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
