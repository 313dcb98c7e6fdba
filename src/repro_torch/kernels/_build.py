"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes`` — no PyTorch headers, so a build
takes seconds.  Builds happen at first use, never at import: importing
``repro_torch`` needs no ``nvcc`` and no CUDA.  Libraries land in
``build/repro_torch/`` at the repository root, named by a hash of the source and flags, so an unchanged
source is not rebuilt within one checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"

#: Every kernel source, built in parallel (one nvcc process each).
SOURCES = ("stencil.cu",)

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: nvcc's output (``-Xptxas -v``: registers, shared memory, spills) per
#: source, from the builds this process ran.
BUILD_LOGS: dict[str, str] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels are built from source at first use")
    return found


def _lib_path(source: str) -> Path:
    text = (CSRC / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{Path(source).stem}_{digest[:16]}.so"


def _start(source: str):
    out = _lib_path(source)
    if out.exists():
        return out, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp, cmd)


def build_all() -> dict[str, Path]:
    """Compile every stale source, all nvcc processes at once; returns
    the library path per source.  Raises with nvcc's output on failure."""
    started = {s: _start(s) for s in SOURCES}
    paths = {}
    for source, (out, job) in started.items():
        if job is not None:
            proc, tmp, cmd = job
            log, _ = proc.communicate()
            BUILD_LOGS[source] = log
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {source} (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{log}")
            os.replace(tmp, out)
        paths[source] = out
    return paths


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            path = build_all()[source]
            lib = ctypes.CDLL(str(path))
            _LIBS[source] = lib
        return lib
