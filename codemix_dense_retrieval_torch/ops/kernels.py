"""Build, load and count the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` at first
use. Libraries land in ``csrc/build/`` under a name that carries a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source is rebuilt and a built one is reused by later processes.
:func:`build_kernels` starts one ``nvcc`` per source, all at once.
``bin_scores.cu`` holds kernel A (bin-major), kernel 2 (its transposed
layout), kernel 5 (``binmax_only``) and kernel 7 (``binub``, the sketch
tier's upper-bound bin maxima), ``bin_scores_int8.cu`` kernel 4,
``flash_attention.cu`` kernel B and ``maxsim.cu`` kernel 6 (the two-stage
rerank's MaxSim). Kernels B and 2 are built on ``sm90.cuh`` (TMA, mbarrier
rings, wgmma).

``LAUNCHES`` holds one plain integer per kernel entry: each wrapper adds one
where it launches its kernel, and nowhere else. Kernels A and 4 count their
two layouts apart, since each layout stands for a TPU kernel or a route of
its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = {
    "bin_scores": "bin_scores.cu",
    "bin_scores_int8": "bin_scores_int8.cu",
    "flash_attention": "flash_attention.cu",
    "maxsim": "maxsim.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
]

LAUNCHES: Dict[str, int] = {
    "bin_scores_bin_major": 0,
    "bin_scores_transposed": 0,
    "bin_scores_int8_bin_major": 0,
    "bin_scores_int8_transposed": 0,
    "binmax_only": 0,
    "binub": 0,
    "flash_attention": 0,
    "maxsim": 0,
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}.{digest}.so"


def build_kernels(names: Iterable[str] = tuple(SOURCES)) -> float:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source running in parallel; returns the wall seconds."""
    t0 = time.perf_counter()
    jobs = []
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]} (rc {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_kernels([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            _LIBS[name] = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise if a launch reported a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
