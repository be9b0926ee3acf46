"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``.cu`` file becomes one shared library with a plain C interface,
compiled for Hopper (``sm_90a``) at first use into
``build/diffmst_torch_kernels/`` at the repository root. File names carry a
hash of every source and of the flags, so an edited source is rebuilt and a
stale library is never loaded. All missing libraries are compiled at once,
one nvcc process per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

__all__ = ["SOURCES", "BUILD_DIR", "build_kernels", "load_library", "build_log", "differentiated"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "diffmst_torch_kernels"
SOURCES = ("scan1p.cu", "comp_fused.cu", "iir_fused.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# ptxas report (registers, shared memory, spills) of each source built by
# this process, keyed by source name.
build_log: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_kernels() -> Dict[str, Path]:
    """Compile every source whose library is missing; return source -> library."""
    tag = _tag()
    targets = {src: BUILD_DIR / f"{Path(src).stem}-{tag}.so" for src in SOURCES}
    missing = {src: out for src, out in targets.items() if not out.exists()}
    if not missing:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src, out in missing.items():
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        jobs.append((src, proc, tmp, out))
    errors = []
    for src, proc, tmp, out in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"--- nvcc {src} (exit {proc.returncode}):\n{err}")
            continue
        build_log[src] = err
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("building the CUDA kernels failed:\n" + "\n".join(errors))
    return targets


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library built from ``source`` (built first if missing)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build_kernels()[source]))
            lib.diffmst_error_string.argtypes = [ctypes.c_int]
            lib.diffmst_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.diffmst_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def differentiated(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on ``tensors``. A wrapper runs the
    calls it does not record through its ``torch.ops.diffmst`` operator,
    which ``torch.export`` traces as one node (fake tensors have no data
    pointer for a launch)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
