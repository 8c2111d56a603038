#!/usr/bin/env python3
"""Resources and tensor-core use of the attention kernels that run bf16 on
the tensor cores: the BTHD/BHTC kernels (rows 7, 3, 8 and 4) and the packed
ones (rows 1 and 2), on the card.

    python scripts/bthd_kernel_report.py

Builds ``csrc/attention_bthd.cu``, ``attention_bthd_bwd.cu``,
``attention_packed.cu`` and ``attention_packed_bwd.cu`` with the port's nvcc
flags plus ``-Xptxas -v`` into ``build/kernel_report/`` and prints, for every
bf16 instantiation in each library (``attention_fwd_mma<C>``,
``attention_dq_mma<C>``, ``attention_dkdv_mma<C>``, C the head dims padded
to a multiple of 16; the forward's layout flag is fixed per library), its
registers, its spill stores and loads, and the number of ``HMMA``
instructions in its SASS (``cuobjdump -sass``); and the HMMA count of each
library's f32 CUDA-core kernels, which must be 0 (the packed libraries hold
no bf16 CUDA-core kernel: their bf16 calls all run the ``*_mma`` kernels).
The bf16 kernels' shared memory is dynamic, set at launch: the headers'
notes (``attention_fwd_mma.cuh``, ``attention_bwd_mma.cuh``) state its
budget.

Prints the card's name and power limit first and a JSON line of the numbers
last. Needs the CUDA toolkit and one card.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "kernel_report"


def build(nvcc: str, flags, source: Path, target: Path) -> str:
    cmd = [nvcc, *flags, "-Xptxas", "-v", "-o", str(target), str(source)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {source.name}:\n{done.stdout}{done.stderr}")
    return done.stdout + done.stderr


def resources(log: str):
    """{mangled kernel name: (registers, spill stores, spill loads)}"""
    found, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if name and spill:
            found[name] = [None, int(spill.group(1)), int(spill.group(2))]
        regs = re.search(r"Used (\d+) registers", line)
        if name and regs and name in found:
            found[name][0] = int(regs.group(1))
    return found


def hmma_counts(cuobjdump: str, library: Path):
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = defaultdict(int), None
    for line in sass.splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            name = func.group(1)
            counts[name] += 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return counts


def readable(mangled: str):
    """(kernel, template width) of a mangled bf16 kernel name, else None."""
    hit = re.search(r"(attention_(?:fwd|dq|dkdv)_mma)ILi(\d+)E", mangled)
    return (hit.group(1), int(hit.group(2))) if hit else None


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("bthd_kernel_report: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from ot_vae_tpu_torch.ops import _build

    print(cs.nvidia_smi(), flush=True)
    nvcc = _build._nvcc()
    cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).with_name("cuobjdump"))
    OUT.mkdir(parents=True, exist_ok=True)
    report = {"kernels": [], "f32_hmma": {}}
    for stem in ("attention_bthd", "attention_bthd_bwd", "attention_packed",
                 "attention_packed_bwd"):
        target = OUT / f"{stem}.so"
        log = build(nvcc, _build.NVCC_FLAGS, _build.SOURCE_DIR / f"{stem}.cu", target)
        hmma = hmma_counts(cuobjdump, target)
        f32 = [k for k in hmma if readable(k) is None]
        for mangled, (regs, stores, loads) in sorted(
                resources(log).items(), key=lambda kv: readable(kv[0]) or ("", 0)):
            name = readable(mangled)
            if name is None:
                continue
            row = {"library": stem, "kernel": name[0], "C": name[1], "registers": regs,
                   "spill_stores": stores, "spill_loads": loads,
                   "hmma": hmma.get(mangled, 0)}
            report["kernels"].append(row)
            print(f"{target.name}: {name[0]}<{name[1]}>: {regs} registers, spill "
                  f"{stores}/{loads} bytes, {row['hmma']} HMMA", flush=True)
        report["f32_hmma"][stem] = sum(hmma[k] for k in f32)
        print(f"{target.name}: {len(f32)} f32 CUDA-core kernels: "
              f"{report['f32_hmma'][stem]} HMMA", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
