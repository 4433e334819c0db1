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
        i64p, f32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float)
        lib.fastio_field_offsets.restype = ctypes.c_long
        lib.fastio_field_offsets.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long, i64p]
        lib.fastio_write_run_ids.restype = ctypes.c_long
        lib.fastio_write_run_ids.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            i64p,
            ctypes.c_long,
            ctypes.c_char_p,
            i64p,
            i64p,
            ctypes.c_long,
            f32p,
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.fastio_write_run.restype = ctypes.c_long
        lib.fastio_write_run.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.c_char_p,
            f32p,
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


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def field_offsets(blob: bytes, n: int) -> Optional[np.ndarray]:
    """The (n + 1,) int64 offsets of the ``n`` newline-ended fields of
    ``blob`` (field i is ``blob[off[i] : off[i + 1] - 1]``), or None without
    the library or when ``blob`` holds another number of newlines."""
    lib = _lib()
    if lib is None:
        return None
    off = np.empty(n + 1, np.int64)
    if lib.fastio_field_offsets(blob, len(blob), n, _ptr(off, ctypes.c_int64)) != n:
        return None
    return off


def write_run_ids(path: str, qids: Sequence[str], ids: np.ndarray, scores: np.ndarray, table, tag: str,
                  precision: int) -> int:
    """Lines written, or -1 when the native path cannot take the call (no
    library, a qid with a newline, a precision outside 0-64). ``ids`` is a
    (Q, k) array of row ids into ``table``, an
    :class:`~codemix_dense_retrieval_torch.io.trec.DocidTable`, which checks
    them. The qid offsets and the contiguous ids and scores are made under
    the span ``trec.marshal``; the C call, which formats and writes every
    line, is ``trec.native_write``."""
    lib = _lib()
    if lib is None:
        return -1
    nq = len(qids)
    with timing.span("trec.marshal"):
        rows = table.check(ids)
        sc = np.ascontiguousarray(scores, dtype=np.float32)
        qid_blob = "".join(f"{q}\n" for q in qids).encode()
        qid_off = field_offsets(qid_blob, nq)
        if qid_off is None:
            return -1
    with timing.span("trec.native_write"):
        return lib.fastio_write_run_ids(
            path.encode(), qid_blob, _ptr(qid_off, ctypes.c_int64), nq,
            table.blob, _ptr(table.offsets, ctypes.c_int64), _ptr(rows, ctypes.c_int64), rows.shape[1],
            _ptr(sc, ctypes.c_float), tag.encode(), precision,
        )


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
    a newline, a precision outside 0-64). Each column crosses as one
    newline-separated buffer, built under the span ``trec.marshal``; the C
    call, which splits the buffers and formats and writes every line, is
    ``trec.native_write``."""
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
    with timing.span("trec.native_write"):
        return lib.fastio_write_run(
            path.encode(), qid_blob, nq, doc_blob, _ptr(sc, ctypes.c_float), k, tag.encode(), precision,
        )


def collapse_run_max(in_path: str, out_path: str, tag: str) -> bool:
    lib = _lib()
    if lib is None:
        return False
    return bool(lib.fastio_collapse_run_max(in_path.encode(), out_path.encode(), tag.encode()))
