"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for ``sm_90a``.
Libraries are built at first use into ``build/kernels/`` at the repository
root, keyed by a hash of the sources and flags, so a changed source never
loads a stale library. ``build`` starts one ``nvcc`` per source, all at
once. Nothing here runs at import time: the CPU tests import every module.

Replica threads can reach a kernel for the first time together, so
``load_library`` builds and loads under one lock, and each build writes to a
temporary file named for its process and thread.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
KERNELS = ("chunked_prefill", "flash_attention", "moe_gmm", "quant_matmul", "ssd_scan")
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    process per source, all started together. Returns each built kernel's
    compiler log (``-Xptxas=-v``: registers, shared memory, spills). Raises
    if any compile fails."""
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        cmd = [_nvcc(), *NVCC_FLAGS]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{logs[name]}")
            continue
        os.replace(tmp, out)       # atomic: a concurrent loader never sees half a file
        out.with_suffix(".log").write_text(logs[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def load_library(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if it is missing; one build
    and one load per process, whichever threads ask at once."""
    with _LOAD_LOCK:
        return _load(name)
