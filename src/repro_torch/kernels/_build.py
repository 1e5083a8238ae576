"""Build the CUDA sources of the port with ``nvcc`` and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
into a shared library for ``sm_90a`` under ``<repo>/build/``, named by the
hash of its source, then loaded with ``ctypes``.  Nothing is built at
import: a library is built the first time a wrapper needs it, or all at
once, in parallel, by ``build_all``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, List

_PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# library name -> its CUDA source
SOURCES: Dict[str, pathlib.Path] = {
    "paged_attention": _PKG / "decode_attention" / "csrc" / "paged_attention.cu",
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _target(name: str) -> pathlib.Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together.  Returns each compiler's output (the
    ``-Xptxas -v`` register and shared-memory report); raises on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for name, src in SOURCES.items():
        target = _target(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, target, tmp, proc))
    logs: Dict[str, str] = {}
    failed: List[str] = []
    for name, target, tmp, proc in jobs:
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            os.unlink(tmp)
            failed.append(f"{name}:\n{logs[name]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if it is missing."""
    target = _target(name)
    if not target.exists():
        build_all()
    return ctypes.CDLL(str(target))
