"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/kernels/`` at the
repository root (listed in ``.gitignore``).  The library's file name carries
a hash of its source and flags, so an edited source is rebuilt and a stale
library is never loaded.  A source with no C++ PyTorch headers builds in
seconds; that is why the port binds through ctypes and not through
``torch.utils.cpp_extension``.

Only the repository's own sources are built.  A failed build raises with the
compiler's output; nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "build_all", "load"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"grouped_gemm": _CSRC / "grouped_gemm.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, dict]:
    """Compile every source whose library is missing, one ``nvcc`` each, all
    started together.  Returns ``{name: {"seconds", "log", "path"}}`` (log is
    the compiler's output, with ``-Xptxas -v``'s register and shared-memory
    report; empty when the library was already built)."""
    report = {
        n: {"seconds": 0.0, "log": "", "path": str(_library_path(n))}
        for n in SOURCES
    }
    missing = [n for n in SOURCES if not _library_path(n).exists()]
    if not missing:
        return report
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in missing:
        lib = _library_path(name)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp, lib, time.monotonic(),
        )
    # Wait for every compiler before reporting a failure: none is left running.
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        report[name].update(seconds=time.monotonic() - t0, log=log)
    for name, (proc, tmp, lib, _) in procs.items():
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed for {SOURCES[name]}:\n{report[name]['log']}"
            )
        os.replace(tmp, lib)
    return report


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (building every missing source first)."""
    lib = _loaded.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build_all()
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
