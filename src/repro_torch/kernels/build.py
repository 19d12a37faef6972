"""Builds the port's CUDA sources into shared libraries and loads them.

Each source under ``kernels/csrc/`` has a plain C interface.  It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into
``<repo>/build/repro_torch/<name>_<hash>.so`` at first use, where the hash
covers the source and the flags, and is loaded with ``ctypes``.  Several
sources build in parallel, one ``nvcc`` each.  A failed build raises: no
caller falls back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Library:
    name: str
    path: Path
    lib: ctypes.CDLL
    seconds: float      # nvcc wall time in this process (0.0 when cached)
    log: str            # nvcc's output, -Xptxas -v lines included


_LOADED: Dict[str, Library] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under PyTorch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       "CUDA_HOME); the port's CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def build(names: Sequence[str]) -> Dict[str, Library]:
    """Build (once per process and source hash) and load ``names``."""
    todo = [n for n in names if n not in _LOADED]
    procs = {}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for n in todo:
        out = _target(n)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out, time.perf_counter())
    for n in todo:
        seconds, log = 0.0, "cached"
        if n in procs:
            proc, tmp, out, t0 = procs[n]
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {n}.cu "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
        out = _target(n)
        _LOADED[n] = Library(n, out, ctypes.CDLL(str(out)), seconds, log)
    return {n: _LOADED[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    return build([name])[name].lib
