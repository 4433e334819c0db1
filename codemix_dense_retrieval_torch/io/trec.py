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
path, whose output is the same bytes. ``WRITES`` counts the calls each path
served.
"""

from __future__ import annotations

import os
import pathlib
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence

import numpy as np

from codemix_dense_retrieval_torch.io import _fastio

PathLike = os.PathLike | str

#: calls of write_run / collapse_run_max served by each path
WRITES: Dict[str, int] = {"native": 0, "python": 0}


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
    docids: Sequence[Sequence[str]],
    scores: np.ndarray,
    tag: str = "onepass",
    precision: int = 4,
) -> int:
    """Write a TREC run; returns the number of lines written. The native
    writer takes the call when it is built and the rows are rectangular."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    n = _fastio.write_run(str(path), qids, docids, np.asarray(scores, np.float32), tag, precision)
    if n >= 0:
        WRITES["native"] += 1
        return n
    WRITES["python"] += 1
    return _write_run_python(path, qids, docids, scores, tag, precision)


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
