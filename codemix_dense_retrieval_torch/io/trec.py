"""TREC run-file IO and the bilingual max-score collapse.

Run-line contract: ``qid Q0 docid rank score tag`` with the score printed at
a fixed precision. Readers split on any whitespace, so the tab-separated
mono runs and the space-separated collapsed runs parse alike.

Bilingual collapse: derived docids are ``base#lang``; a collapsed run keeps,
per (qid, base), the max score over languages, re-ranked by score
descending (first-seen qid order, 6-decimal scores, a stable sort within a
qid).

A C++ fast path (``csrc/fastio.cpp``, :mod:`._fastio`) writes and collapses
multi-million-line runs; without it both functions take their pure-Python
path, whose output is the same bytes. A search's hits reach ``write_run``
as row ids with the index's :class:`DocidTable` (``table=``), so no Python
string is made per hit; other callers pass string rows. ``WRITES`` counts
the calls each path served and those given a table (always); while
tracing (:mod:`~codemix_dense_retrieval_torch.utils.timing`), ``write_run``
is the span ``trec.write`` around ``trec.marshal`` and
``trec.native_write``, or ``trec.python_write``, and counts ``trec.lines``,
``trec.bytes`` and, given a table, ``trec.table_writes``.
"""

from __future__ import annotations

import os
import pathlib
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from codemix_dense_retrieval_torch.io import _fastio
from codemix_dense_retrieval_torch.utils import timing

PathLike = os.PathLike | str

#: calls of write_run / collapse_run_max served by each path, and calls of
#: write_run given a docid table
WRITES: Dict[str, int] = {"native": 0, "python": 0, "table": 0}


@dataclass(frozen=True, eq=False)
class DocidTable:
    """The docids of an index's rows as one UTF-8 blob of newline-ended
    fields and their (N + 1,) int64 offsets: row i's docid is
    ``blob[offsets[i] : offsets[i + 1] - 1]``. A hole (None) of a mutated
    index is an empty field."""

    blob: bytes
    offsets: np.ndarray

    def __post_init__(self) -> None:
        # the native writer reads the fields these offsets name
        off = self.offsets
        if (not isinstance(self.blob, bytes) or off.dtype != np.int64 or off.ndim != 1 or len(off) == 0
                or not off.flags.c_contiguous or off[0] != 0 or off[-1] != len(self.blob)
                or (np.diff(off) < 1).any()):
            raise ValueError("a DocidTable's offsets must rise from 0 to len(blob), one newline-ended field each")

    @classmethod
    def build(cls, docids: Sequence) -> "DocidTable":
        """One join and one encode; the native library finds the offsets
        (by the encoded lengths without it, or when a docid holds a
        newline)."""
        items = docids.tolist() if isinstance(docids, np.ndarray) else list(docids)
        try:
            text = "\n".join(items)
        except TypeError:   # holes, or ids that are not strings
            items = ["" if d is None else f"{d}" for d in items]
            text = "\n".join(items)
        blob = (text + "\n").encode() if items else b""
        offsets = _fastio.field_offsets(blob, len(items))
        if offsets is None:
            offsets = np.zeros(len(items) + 1, np.int64)
            np.cumsum([len(s.encode()) + 1 for s in items], out=offsets[1:])
        return cls(blob, offsets)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def check(self, ids) -> np.ndarray:
        """``ids`` as a C-contiguous int64 array; ValueError for an id
        outside the table."""
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= len(self)):
            raise ValueError(f"row ids outside a docid table of {len(self)} rows")
        return ids

    def rows(self, ids) -> np.ndarray:
        """The docids (object array of str) of the row ids ``ids``."""
        ids = self.check(ids)
        off, blob = self.offsets, self.blob
        out = [blob[off[i] : off[i + 1] - 1].decode() for i in ids.ravel().tolist()]
        return np.asarray(out, dtype=object).reshape(ids.shape)


@dataclass(frozen=True)
class RunEntry:
    qid: str
    docid: str
    rank: int
    score: float
    tag: str = "run"


def read_run(path: PathLike) -> List[RunEntry]:
    out: List[RunEntry] = []
    with open(path, "r", encoding="utf-8") as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            qid, _, docid, rank, score, tag = line.split()
            out.append(RunEntry(qid, docid, int(rank), float(score), tag))
    return out


def iter_run_lines(
    qids: Sequence[str],
    docids: Sequence[Sequence[str]],
    scores: np.ndarray,
    tag: str,
    precision: int = 4,
) -> Iterable[str]:
    """Yield TREC lines for batched search output: ``docids[i][j]`` is the
    docid of hit j for query i, ``scores`` a (num_queries, k) array."""
    for i, qid in enumerate(qids):
        row_docs = docids[i]
        row_scores = scores[i]
        for rank, (doc, sc) in enumerate(zip(row_docs, row_scores), 1):
            yield f"{qid}\tQ0\t{doc}\t{rank}\t{sc:.{precision}f}\t{tag}"


def _write_run_python(path: pathlib.Path, qids, docids, scores, tag: str, precision: int) -> int:
    lines = list(iter_run_lines(qids, docids, scores, tag, precision))
    path.write_text("\n".join(lines) + ("\n" if lines else ""), encoding="utf-8")
    return len(lines)


def write_run(
    path: PathLike,
    qids: Sequence[str],
    docids,
    scores: np.ndarray,
    tag: str = "onepass",
    precision: int = 4,
    *,
    table: Optional[DocidTable] = None,
) -> int:
    """Write a TREC run; returns the number of lines written. ``docids``
    holds string rows, or with ``table`` a (Q, k) integer array of row ids
    into it. The native writer takes the call when it is built and the rows
    are rectangular."""
    path = pathlib.Path(path)
    with timing.span("trec.write"):
        path.parent.mkdir(parents=True, exist_ok=True)
        sc = np.asarray(scores, np.float32)
        if table is not None:
            ids = np.asarray(docids)
            if ids.ndim != 2 or ids.shape != sc.shape or len(ids) != len(qids):
                raise ValueError(f"row ids {ids.shape} vs scores {sc.shape} for {len(qids)} queries")
            WRITES["table"] += 1
            timing.count("trec.table_writes")
            n = _fastio.write_run_ids(str(path), qids, ids, sc, table, tag, precision)
        else:
            n = _fastio.write_run(str(path), qids, docids, sc, tag, precision)
        if n >= 0:
            WRITES["native"] += 1
        else:
            WRITES["python"] += 1
            with timing.span("trec.python_write"):
                rows = docids if table is None else table.rows(ids)
                n = _write_run_python(path, qids, rows, scores, tag, precision)
        if timing.tracing():
            timing.count("trec.lines", n)
            timing.count("trec.bytes", path.stat().st_size)
    return n


def write_run_entries(path: PathLike, entries: Iterable[RunEntry]) -> int:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for e in entries:
            f.write(f"{e.qid}\tQ0\t{e.docid}\t{e.rank}\t{e.score:.6f}\t{e.tag}\n")
            n += 1
    return n


def collapse_run_max(in_run: PathLike, out_run: PathLike, tag: str = "bilingual-onepass") -> None:
    """Collapse ``docid#lang`` duplicates by max score, re-rank, rewrite:
    first-seen qid order, 6-decimal scores, stable sort by score descending
    within a qid (ties keep first-seen order)."""
    pathlib.Path(out_run).parent.mkdir(parents=True, exist_ok=True)
    if _fastio.collapse_run_max(str(in_run), str(out_run), tag):
        WRITES["native"] += 1
        return
    WRITES["python"] += 1
    by_q: Dict[str, Dict[str, float]] = {}
    with open(in_run, "r", encoding="utf-8") as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            qid, _, did, _rk, sc, _tag = line.split()
            base = did.split("#", 1)[0]
            score = float(sc)
            groups = by_q.setdefault(qid, {})
            if base not in groups or score > groups[base]:
                groups[base] = score
    with open(out_run, "w", encoding="utf-8") as out:
        for qid, groups in by_q.items():
            items = sorted(groups.items(), key=lambda x: x[1], reverse=True)
            for rank, (base, val) in enumerate(items, 1):
                out.write(f"{qid} Q0 {base} {rank} {val:.6f} {tag}\n")
