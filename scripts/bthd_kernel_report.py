#!/usr/bin/env python3
"""Resources and tensor-core use of the kernels that run bf16 on the tensor
cores: the BTHD/BHTC kernels (rows 7, 3, 8 and 4), the packed ones (rows 1
and 2) and the fused attention block's (rows 5 and 6), on the card; and the
resources of the Sinkhorn kernel (row 9).

    python scripts/bthd_kernel_report.py

Builds ``csrc/attention_bthd.cu``, ``attention_bthd_bwd.cu``,
``attention_packed.cu``, ``attention_packed_bwd.cu``, ``attention_block.cu``
and ``attention_block_bwd.cu`` (and ``sinkhorn_log.cu``) with the port's
nvcc flags plus ``-Xptxas -v`` into ``build/kernel_report/`` (one nvcc each,
all at once) and sorts every kernel of each library into one of three kinds
by its name:

- ``mma``: the bf16 tensor-core kernels (``attention_fwd_mma<C>``,
  ``attention_dq_mma<C>``, ``attention_dkdv_mma<C>``, C the head dims padded
  to a multiple of 16; the block libraries' ``attn_from_lse_mma<C>``, their
  GEMM ``mma_gemm_kernel<A layout, B layout, output type>`` and their qkv
  projection ``exact_gemm_kernel``, which sums on the FP64 tensor cores).
  Each line gives its registers, its spill stores and loads in bytes and the
  numbers of ``HMMA`` and ``DMMA`` instructions in its SASS (``cuobjdump
  -sass``), which must not both be 0;
- ``no products``: the block libraries' bf16 cast of the weights
  (``cast_weights_kernel``) and the in-order sum of the weight gradients'
  K splits (``reduce_splits_kernel``, both dtypes), which multiply nothing;
- ``f32``: the CUDA-core kernels that every library keeps for f32 calls,
  which must hold neither.

So no bf16 product runs on CUDA cores: every bf16 call of the six
libraries launches ``mma`` kernels for its products. The bf16 kernels'
attention tiles are dynamic shared memory, set at launch (the headers'
notes, ``attention_fwd_mma.cuh`` and ``attention_bwd_mma.cuh``, state the
budget); ``mma_gemm_kernel``'s is static. Every kernel of
``sinkhorn_log.cu`` (f32, CUDA cores) gets a line of its registers, spills
and static shared memory, and the Sinkhorn launch plans' dynamic shared
memory a CTA is printed at chip_smoke.py's timed shapes.

Prints the card's name and power limit first and a JSON line of the numbers
last; exits 1 if a kind's rule does not hold. Needs the CUDA toolkit
and one card.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "kernel_report"
LIBRARIES = ("attention_bthd", "attention_bthd_bwd", "attention_packed", "attention_packed_bwd",
             "attention_block", "attention_block_bwd", "sinkhorn_log")
# libraries each of whose kernels gets a line of its resources, whatever its kind
RESOURCE_LINES = ("sinkhorn_log",)
MMA = ("attention_fwd_mma", "attention_dq_mma", "attention_dkdv_mma", "attn_from_lse_mma",
       "mma_gemm_kernel", "exact_gemm_kernel")
NO_PRODUCTS = ("cast_weights_kernel", "reduce_splits_kernel")


def build(nvcc: str, flags, source: Path, target: Path) -> str:
    cmd = [nvcc, *flags, "-Xptxas", "-v", "-o", str(target), str(source)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {source.name}:\n{done.stdout}{done.stderr}")
    return done.stdout + done.stderr


def resources(log: str):
    """{mangled kernel name: [registers, spill stores, spill loads, static
    shared memory bytes]}"""
    found, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if name and spill:
            found[name] = [None, int(spill.group(1)), int(spill.group(2)), 0]
        regs = re.search(r"Used (\d+) registers", line)
        if name and regs and name in found:
            found[name][0] = int(regs.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            found[name][3] = int(smem.group(1)) if smem else 0
    return found


def mma_counts(cuobjdump: str, library: Path):
    """{mangled kernel name: {"HMMA": n, "DMMA": n}} from the SASS"""
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            name = func.group(1)
            counts.setdefault(name, {"HMMA": 0, "DMMA": 0})
        elif name:
            for op in ("HMMA", "DMMA"):
                counts[name][op] += op in line
    return counts


def demangler(nvcc: str):
    """mangled name -> readable name, through cu++filt or c++filt where
    either is installed (else the mangled name)"""
    tool = Path(nvcc).with_name("cu++filt")
    tool = str(tool) if tool.exists() else shutil.which("c++filt")
    if tool is None:
        return lambda name: name

    def readable(name: str) -> str:
        done = subprocess.run([tool, name], capture_output=True, text=True)
        text = done.stdout.strip() if done.returncode == 0 else name
        # drop the return type, casts of template arguments, the argument
        # list and the namespaces
        text = re.sub(r"^void ", "", re.sub(r"\((int|bool)\)", "", text))
        text = re.sub(r"\([^()]*\)$", "", text)
        return re.sub(r"(\w+::|<unnamed>::|\(anonymous namespace\)::)", "", text)

    return readable


def kind(mangled: str) -> str:
    if any(k in mangled for k in MMA):
        return "mma"
    if any(k in mangled for k in NO_PRODUCTS):
        return "no products"
    return "f32"


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
    readable = demangler(nvcc)
    OUT.mkdir(parents=True, exist_ok=True)
    report = {"kernels": [], "resources": [], "f32_mma": {}, "no_products_mma": {}}
    broken = []
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:  # one nvcc each, all at once
        logs = list(pool.map(lambda stem: build(nvcc, _build.NVCC_FLAGS,
                                                _build.SOURCE_DIR / f"{stem}.cu",
                                                OUT / f"{stem}.so"), LIBRARIES))
    for stem, log in zip(LIBRARIES, logs):
        target = OUT / f"{stem}.so"
        counts = mma_counts(cuobjdump, target)
        used = resources(log)
        by_kind = defaultdict(list)
        for mangled in counts:
            by_kind[kind(mangled)].append(mangled)
        for mangled in sorted(by_kind["mma"], key=readable):
            regs, stores, loads, _ = used.get(mangled, (None, None, None, None))
            row = {"library": stem, "kernel": readable(mangled), "registers": regs,
                   "spill_stores": stores, "spill_loads": loads,
                   "hmma": counts[mangled]["HMMA"], "dmma": counts[mangled]["DMMA"]}
            report["kernels"].append(row)
            print(f"{target.name}: {row['kernel']}: {regs} registers, spill "
                  f"{stores}/{loads} bytes, {row['hmma']} HMMA, {row['dmma']} DMMA", flush=True)
            if row["hmma"] + row["dmma"] == 0:
                broken.append(f"{stem}: {row['kernel']} holds no HMMA or DMMA")
        if stem in RESOURCE_LINES:
            for mangled in sorted(counts, key=readable):
                regs, stores, loads, smem = used.get(mangled, (None, None, None, None))
                row = {"library": stem, "kernel": readable(mangled), "registers": regs,
                       "spill_stores": stores, "spill_loads": loads, "static_smem": smem}
                report["resources"].append(row)
                print(f"{target.name}: {row['kernel']}: {regs} registers, spill "
                      f"{stores}/{loads} bytes, {smem} bytes static shared memory", flush=True)
        for key, name in (("f32", "f32_mma"), ("no products", "no_products_mma")):
            report[name][stem] = sum(sum(counts[k].values()) for k in by_kind[key])
            print(f"{target.name}: {len(by_kind[key])} {key} kernels: "
                  f"{report[name][stem]} HMMA or DMMA", flush=True)
            if report[name][stem]:
                broken.append(f"{stem}: {key} kernels hold HMMA or DMMA")
    from ot_vae_tpu_torch.ops.sinkhorn import _launch_plan

    report["sinkhorn_plans"] = {}
    for _, n, m in cs.SINKHORN_TIMED:
        lp = _launch_plan(n, m)
        report["sinkhorn_plans"][f"{n}x{m}"] = lp._asdict()
        print(f"sinkhorn_log plan N={n} M={m}: cluster {lp.cluster}, {lp.rows} rows a CTA "
              f"({lp.resident} resident, {lp.streamed} streamed), {lp.slices} slices, "
              f"{lp.smem_bytes} bytes dynamic shared memory a CTA", flush=True)
    print(json.dumps(report))
    for line in broken:
        print(f"bthd_kernel_report: {line}", file=sys.stderr)
    return 1 if broken else 0


if __name__ == "__main__":
    sys.exit(main())
