"""On-device bilingual collapse-max.

The host path (:func:`~codemix_dense_retrieval_torch.io.trec.collapse_run_max`)
collapses ``docid#lang`` duplicates after the raw run is written. The fused
bilingual sweep does the same max-score collapse on the top-k tensors, so
the alpha sweep, the collapse and the metrics stay on the device.

Applicability: hubs whose two language stores are PARALLEL corpora (the
same docids in the same order), so a row's base id is ``gid mod n_first``.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = float(-3.4e38)
# the base id of a duplicate entry: past every real base, so it sorts last
# among equal scores
_DUP_BASE = 2**30


def _sort2(key1: torch.Tensor, key2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort each row by (key1 asc, key2 asc): two stable sorts, the secondary
    key first."""
    order = torch.argsort(key2, dim=1, stable=True)
    key1, key2 = torch.gather(key1, 1, order), torch.gather(key2, 1, order)
    order = torch.argsort(key1, dim=1, stable=True)
    return torch.gather(key1, 1, order), torch.gather(key2, 1, order)


def collapse_topk_parallel_hub(
    vals: torch.Tensor,  # (B, k) scores, descending
    gids: torch.Tensor,  # (B, k) global row ids in the concatenated hub
    n_first: int,        # rows of the first language store
    k_out: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collapse per-query results by base id ``gid % n_first``, keeping the
    max score per base, re-ranked by (score desc, base asc). Slots past the
    number of distinct bases come back with score ``NEG_INF`` and id -1."""
    base = torch.where(gids >= n_first, gids - n_first, gids)
    # (base asc, -score asc): each base group's max-score entry comes first
    b_sorted, negv_sorted = _sort2(base, -vals.to(torch.float32))
    dup = torch.zeros_like(b_sorted, dtype=torch.bool)
    dup[:, 1:] = b_sorted[:, 1:] == b_sorted[:, :-1]
    v_kept = torch.where(dup, NEG_INF, -negv_sorted)
    b_kept = torch.where(dup, _DUP_BASE, b_sorted)
    # final order: score desc, base asc
    neg2, base_out = _sort2(-v_kept, b_kept)
    vals_out = -neg2[:, :k_out]
    ids_out = torch.where(vals_out <= NEG_INF / 2, -1, base_out[:, :k_out])
    return vals_out, ids_out
