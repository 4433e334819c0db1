"""Query-embedding cache: ``<cache_root>/<lang>/queries.npz {qids, vecs}``,
the same file format as the JAX package's, validated on load by an exact
qid-list match.
"""

from __future__ import annotations

import pathlib
from typing import Optional, Sequence, Tuple

import numpy as np


class QueryCacheMismatch(ValueError):
    pass


def save_query_cache(path, qids: Sequence[str], vecs: np.ndarray) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, qids=np.asarray(list(qids), dtype=np.str_), vecs=np.asarray(vecs, np.float32))


def load_query_cache(
    path, expected_qids: Optional[Sequence[str]] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (qids, vecs); raises QueryCacheMismatch when the cached qid
    list differs from ``expected_qids`` (the reference treats that as a
    stale cache and re-encodes)."""
    data = np.load(path, allow_pickle=False)
    qids = data["qids"].astype(str)
    vecs = data["vecs"].astype(np.float32)
    if len(qids) != len(vecs):
        raise QueryCacheMismatch(f"{path}: {len(qids)} qids vs {len(vecs)} vecs")
    if expected_qids is not None and list(qids) != [str(q) for q in expected_qids]:
        raise QueryCacheMismatch(f"{path}: cached qid list differs from expected")
    return qids, vecs
