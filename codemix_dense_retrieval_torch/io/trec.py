"""TREC run-file IO.

Run-line contract: ``qid\\tQ0\\tdocid\\trank\\tscore\\ttag`` with the score
printed at a fixed precision. Readers split on any whitespace.
"""

from __future__ import annotations

import os
import pathlib
from typing import Iterable, Sequence

import numpy as np

PathLike = os.PathLike | str


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


def write_run(
    path: PathLike,
    qids: Sequence[str],
    docids: Sequence[Sequence[str]],
    scores: np.ndarray,
    tag: str = "onepass",
    precision: int = 4,
) -> int:
    """Write a TREC run; returns the number of lines written."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = list(iter_run_lines(qids, docids, scores, tag, precision))
    path.write_text("\n".join(lines) + ("\n" if lines else ""), encoding="utf-8")
    return len(lines)
