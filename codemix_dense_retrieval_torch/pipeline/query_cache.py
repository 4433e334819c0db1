"""Query-embedding cache: ``<cache_root>/<lang>/queries.npz {qids, vecs}``
(and the two-stage ``{qids, vecs, tokens, lengths}`` variant),
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


def save_query_token_cache(
    path, qids: Sequence[str], vecs: np.ndarray,
    tokens: np.ndarray, lengths: np.ndarray,
) -> None:
    """Two-stage variant: dense vecs + token blocks + valid lengths in one
    npz (the JAX package's format). Tokens stay f32, so a cached run and a
    fresh one score the same values."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        path,
        qids=np.asarray(list(qids), dtype=np.str_),
        vecs=np.asarray(vecs, np.float32),
        tokens=np.asarray(tokens, np.float32),
        lengths=np.asarray(lengths, np.int32),
    )


def load_query_token_cache(
    path, expected_qids: Optional[Sequence[str]] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (qids, vecs, tokens f32, lengths); the qid check is that of
    :func:`load_query_cache`."""
    data = np.load(path, allow_pickle=False)
    qids = data["qids"].astype(str)
    vecs = data["vecs"].astype(np.float32)
    tokens = data["tokens"].astype(np.float32)
    lengths = data["lengths"].astype(np.int32)
    if not (len(qids) == len(vecs) == len(tokens) == len(lengths)):
        raise QueryCacheMismatch(
            f"{path}: inconsistent row counts "
            f"({len(qids)}/{len(vecs)}/{len(tokens)}/{len(lengths)})"
        )
    if expected_qids is not None and list(qids) != [str(q) for q in expected_qids]:
        raise QueryCacheMismatch(f"{path}: cached qid list differs from expected")
    return qids, vecs, tokens, lengths
