"""Build, load and count the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` at first
use. Libraries land in ``csrc/build/`` under a name that carries a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source is rebuilt and a built one is reused by later processes.
:func:`build_kernels` starts one ``nvcc`` per source, all at once. ``nvcc``
runs with ``-Xptxas -v``, and its log is kept beside the library
(:func:`build_log`); :func:`ptxas_report` reads each kernel's registers and
spill bytes and ptxas's warnings out of it (C7518: wgmma serialised).
``bin_scores.cu`` holds kernel A (bin-major), kernel 2 (its transposed
layout), kernel 5 (``binmax_only``) and kernel 7 (``binub``, the sketch
tier's upper-bound bin maxima) over bf16 operands, ``bin_scores_f16.cu``
kernels A, 2 and 5 over f16 and ``bin_scores_f32.cu`` kernels A, 2, 5 and 7
over f32 (3xTF32), ``bin_scores_int8.cu`` kernel 4 (both layouts),
``flash_attention.cu`` kernel B, ``maxsim.cu`` kernel 6 (the two-stage
rerank's MaxSim, bf16, f16 or f32 doc tokens), ``cover_rescore.cu`` the
scores of the rows a two-level cover selected, summed as kernel A sums them
(bf16 or f16: the exact route whose phase 1 is kernel 5), and
``super_select.cu`` the super level of the two-level cover (each query's best supers from the
bin maxima, no tensor cores), and ``kda_chunk.cu`` Kimi Delta Attention's
chunked gated delta-rule scan (``ops/kda.py``; TF32 ``mma.sync``, no TMA),
``kda_ops.cu`` the elementwise steps of its block (convolution, gates,
output norm),
and ``moe_rows.cu`` the row moves of a mixture-of-experts layer that holds
a share of its experts (``ops/grouped_mm.py``).
The bin-score
kernels (A, 2, 4, 5, 7) are two templates in ``bin_kernels.cuh``,
instantiated per operand type and epilogue; they, ``cover_rescore`` and
kernel B are built on ``sm90.cuh`` (TMA, mbarrier rings, wgmma). Each
operand type of the bin-score kernels is a source of its own with the same
C entry points, picked by the dtype's name suffix, while ``maxsim.cu`` and
``cover_rescore.cu`` take their dtype as an argument: every bin-score
source instantiates dozens of wgmma kernels (layout x epilogue x tile x bin
size), and one source per type lets :func:`build_kernels` run their
``nvcc`` side by side instead of one after another.

``LAUNCHES`` holds one plain integer per kernel instance: each wrapper adds
one where it launches its kernel, and nowhere else. Kernels A and 4 count
their two layouts apart, since each layout stands for a TPU kernel or a
route of its own; the f16 and f32 instances of kernels A, 2, 5, 6 and 7 and
the f16 one of ``cover_rescore`` count under their own names (suffix
``_f16`` / ``_f32``: :func:`dtype_suffix`), and kernel B's causal instance
(the Qwen3 encoder's) under ``flash_attention_causal``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = {
    "bin_scores": "bin_scores.cu",
    "bin_scores_f16": "bin_scores_f16.cu",
    "bin_scores_f32": "bin_scores_f32.cu",
    "bin_scores_int8": "bin_scores_int8.cu",
    "flash_attention": "flash_attention.cu",
    "maxsim": "maxsim.cu",
    "cover_rescore": "cover_rescore.cu",
    "super_select": "super_select.cu",
    "kda_chunk": "kda_chunk.cu",
    "kda_ops": "kda_ops.cu",
    "moe_rows": "moe_rows.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
]

LAUNCHES: Dict[str, int] = {
    "bin_scores_bin_major": 0,
    "bin_scores_transposed": 0,
    "bin_scores_bin_major_f16": 0,
    "bin_scores_transposed_f16": 0,
    "bin_scores_bin_major_f32": 0,
    "bin_scores_transposed_f32": 0,
    "bin_scores_int8_bin_major": 0,
    "bin_scores_int8_transposed": 0,
    "binmax_only": 0,
    "binmax_only_f16": 0,
    "binmax_only_f32": 0,
    "binub": 0,
    "binub_f32": 0,
    "flash_attention": 0,
    "flash_attention_causal": 0,
    "maxsim": 0,
    "maxsim_f16": 0,
    "maxsim_f32": 0,
    "cover_rescore": 0,
    "cover_rescore_f16": 0,
    "super_select": 0,
    "kda_chunk": 0,
    "kda_conv": 0,
    "kda_gate": 0,
    "kda_out": 0,
    "moe_gather": 0,
    "moe_act": 0,
    "moe_combine": 0,
}

_SUFFIX = {"torch.bfloat16": "", "torch.float16": "_f16", "torch.float32": "_f32"}


def dtype_suffix(dtype) -> str:
    """The name suffix of a kernel instance over operands of ``dtype`` (a
    torch dtype): "" for bf16, "_f16", "_f32"; a ValueError for others."""
    try:
        return _SUFFIX[str(dtype)]
    except KeyError:
        raise ValueError(f"no kernel instance takes {dtype} operands (bf16, f16 or f32)") from None

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
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The ``nvcc -Xptxas -v`` log of kernel ``name``'s library, built on
    first use."""
    build_kernels([name])
    return _library_path(name).with_suffix(".log").read_text()


_PTXAS_ENTRY = re.compile(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str) -> Dict[str, object]:
    """ptxas's verdict from an ``nvcc -Xptxas -v`` log: ``{"warnings": [line,
    ...], "kernels": {mangled name: {"registers": R, "spill_bytes": S}},
    "serialized": [kernels whose wgmma ptxas serialised (C7518 and kin)]}``.
    Spill bytes are the stores plus the loads."""
    warnings: List[str] = []
    found: Dict[str, Dict[str, int]] = {}
    serialized: List[str] = []
    current = None
    for line in log.splitlines():
        # ptxas prints the wgmma serialisation notes (C7510-C7520) as
        # "warning" or as "info" depending on its version
        if "warning" in line or "Potential Performance Loss" in line:
            warnings.append(line.strip())
            if "wgmma" in line and "serialized" in line:
                named = re.search(r"function '([\w$]+)'", line)
                serialized.append(named.group(1) if named else line.strip())
            continue
        m = _PTXAS_ENTRY.search(line)
        if m:
            current = m.group(1)
            found.setdefault(current, {"registers": 0, "spill_bytes": 0})
            continue
        if current is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            found[current]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = _PTXAS_REGS.search(line)
        if m:
            found[current]["registers"] = int(m.group(1))
    kernels = {k: v for k, v in found.items() if v["registers"] > 0}
    return {"warnings": warnings, "kernels": kernels, "serialized": serialized}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_kernels([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            _LIBS[name] = lib
        return lib


def launch(fn, device: torch.device, *args) -> int:
    """Call the ctypes entry point ``fn(*args, stream)`` with ``device``, the
    card its operands lie on, as the current CUDA device and that device's
    current stream as the last argument; returns ``fn``'s return code. The
    C side sets kernel attributes, sizes its persistent grids by the SMs of
    the runtime's current device and launches there, so without the guard
    operands on ``cuda:1`` would be launched in ``cuda:0``'s context."""
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def check(rc: int, name: str) -> None:
    """Raise if a launch reported a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
