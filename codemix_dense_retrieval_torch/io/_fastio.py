"""ctypes bindings for the native fast-IO library (``csrc/fastio.cpp``).

The library is compiled with ``g++`` at first use into ``csrc/build/``,
under a name that carries a hash of the source and the flags (the scheme of
:mod:`~codemix_dense_retrieval_torch.ops.kernels`), so an edited source is
rebuilt and a built one is reused by later processes. When ``g++`` is
missing or the build fails, :func:`available` is False and the callers in
:mod:`~codemix_dense_retrieval_torch.io.trec` take their pure-Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

from codemix_dense_retrieval_torch.ops.kernels import BUILD_DIR, CSRC
from codemix_dense_retrieval_torch.utils import timing

SOURCE = CSRC / "fastio.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_LIB: Optional[ctypes.CDLL] = None
_LOAD_TRIED = False
_LOCK = threading.Lock()


def library_path() -> pathlib.Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libfastio.{h.hexdigest()[:16]}.so"


def build() -> bool:
    """Compile the library unless it is built; returns whether it exists."""
    out = library_path()
    if out.exists():
        return True
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LOAD_TRIED
    with _LOCK:
        if _LOAD_TRIED:
            return _LIB
        _LOAD_TRIED = True
        if not build():
            return None
        try:
            lib = ctypes.CDLL(str(library_path()))
        except OSError:
            return None
        lib.fastio_write_run.restype = ctypes.c_long
        lib.fastio_write_run.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.fastio_collapse_run_max.restype = ctypes.c_int
        lib.fastio_collapse_run_max.argtypes = [ctypes.c_char_p] * 3
        _LIB = lib
        return _LIB


def available() -> bool:
    """Whether the native library is loaded (built on first call)."""
    return _lib() is not None


def write_run(
    path: str,
    qids: Sequence[str],
    docids: Sequence[Sequence[str]],
    scores: np.ndarray,
    tag: str,
    precision: int,
) -> int:
    """Lines written, or -1 when the native path cannot take the call
    (no library, ragged rows, a score array of another shape, a field with
    a newline). Each column crosses as one newline-separated buffer, built
    under the span ``trec.marshal``; the C call is ``trec.native_write``."""
    lib = _lib()
    if lib is None:
        return -1
    nq = len(qids)
    if nq == 0:
        pathlib.Path(path).write_text("")
        return 0
    with timing.span("trec.marshal"):
        docs = np.asarray(docids, dtype=object)
        sc = np.ascontiguousarray(scores, dtype=np.float32)
        if docs.ndim != 2 or docs.shape[0] != nq or sc.shape != docs.shape:
            return -1
        k = docs.shape[1]
        qid_blob = ("\n".join(map(str, qids)) + "\n").encode()
        doc_blob = ("\n".join(map(str, docs.ravel().tolist())) + "\n").encode()
        if qid_blob.count(b"\n") != nq or doc_blob.count(b"\n") != nq * k:
            return -1
    with timing.span("trec.native_write"):
        return lib.fastio_write_run(
            path.encode(), qid_blob, nq, doc_blob,
            sc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), k, tag.encode(), precision,
        )


def collapse_run_max(in_path: str, out_path: str, tag: str) -> bool:
    lib = _lib()
    if lib is None:
        return False
    return bool(lib.fastio_collapse_run_max(in_path.encode(), out_path.encode(), tag.encode()))
