"""Build the CUDA sources in ``ops/csrc/`` with ``nvcc`` and load them.

Each ``*.cu`` file becomes one shared library with a plain C interface,
compiled for ``sm_90a`` into ``build/kernels/`` at the repository root and
loaded with ``ctypes``. The file name carries a hash of the source, of
every header (``*.cuh``) beside it and of the flags, so an edited source or
header is rebuilt and an unchanged one is reused. All sources are compiled
at once, one ``nvcc`` process each.

Nothing here runs at import: the CPU tests import every module, and there
is no ``nvcc`` on a machine without the CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["build_all", "load_library", "BUILD_DIR", "SOURCE_DIR"]

SOURCE_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libraries: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(SOURCE_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, all in parallel.

    :return: seconds each compiled source took, by source stem (empty when
        every library was already built)
    """
    todo = {s: _target(s) for s in sorted(SOURCE_DIR.glob("*.cu"))
            if not _target(s).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    started = time.perf_counter()
    procs = {}
    for source, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)]
        procs[source] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, target)
    seconds, failures = {}, []
    for source, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        seconds[source.stem] = time.perf_counter() - started
        if proc.returncode != 0:
            failures.append(f"{source.name}:\n{log}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if needed)."""
    if stem not in _libraries:
        source = SOURCE_DIR / f"{stem}.cu"
        target = _target(source)
        if not target.exists():
            build_all()
        _libraries[stem] = ctypes.CDLL(str(target))
    return _libraries[stem]
