"""Exact inner-product search and the vector mix, in plain float32.

- :func:`safe_mix`: the paper's vector mix, ``(1 - alpha) * a + alpha * b``
  renormalized; at alpha 0 and 1 the endpoint vector as it is.
- :func:`exact_topk`: the k largest inner products of each query over rows
  handed over in blocks (FAISS ``IndexFlatIP`` semantics), ties to the lower
  row id, with the score of each given row id on the way
  (:func:`exact_topk` ``score_ids``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from reference import true_f32


def safe_mix(a: torch.Tensor, b: torch.Tensor, alpha: float) -> torch.Tensor:
    a, b = a.to(torch.float32), b.to(torch.float32)
    if abs(alpha) <= 1e-8:
        return a
    if abs(alpha - 1.0) <= 1e-8:
        return b
    m = (1.0 - alpha) * a + alpha * b
    return m / m.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def exact_topk(
    queries: torch.Tensor,
    rows_of: Callable[[int, int], torch.Tensor],
    n_rows: int,
    k: int,
    *,
    block: int = 262_144,
    score_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(values (B, k), row ids (B, k), scores of ``score_ids``) for f32
    ``queries`` (B, d) over rows ``rows_of(c0, c1)`` (f32, (c1 - c0, d)),
    block by block, with a running merge that keeps (score desc, id asc).
    ``score_ids`` (B, m) row ids whose scores are returned as (B, m) (-inf
    where an id is out of range)."""
    q = queries.to(torch.float32)
    vals = q.new_empty((len(q), 0))
    ids = torch.empty((len(q), 0), dtype=torch.long, device=q.device)
    picked = None
    if score_ids is not None:
        picked = torch.full(score_ids.shape, float("-inf"), device=q.device)
    with true_f32():
        for c0 in range(0, n_rows, block):
            c1 = min(c0 + block, n_rows)
            rows = rows_of(c0, c1).to(torch.float32)
            s = q @ rows.T
            if picked is not None:
                inside = (score_ids >= c0) & (score_ids < c1)
                if inside.any():
                    local = (score_ids - c0).clamp(0, c1 - c0 - 1)
                    got = torch.gather(s, 1, local)
                    picked = torch.where(inside, got, picked)
            bv, bi = _block_topk(s, min(k, c1 - c0))
            v = torch.cat([vals, bv], dim=1)
            i = torch.cat([ids, bi + c0], dim=1)
            # earlier blocks hold lower ids, and each part is already in
            # (score desc, id asc) order: a stable sort keeps ties id-ascending
            sv, order = torch.sort(v, dim=1, descending=True, stable=True)
            vals, ids = sv[:, :k], torch.gather(i, 1, order[:, :k])
    return vals, ids, picked


def _block_topk(s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best of each row of one block's scores in (score desc, column
    asc) order. ``torch.topk`` picks among ties at the k-th value freely, so
    rows with such a tie are taken by a full stable sort instead."""
    tv, ti = torch.topk(s, k, dim=1)
    ti, perm = torch.sort(ti, dim=1)
    tv = torch.gather(tv, 1, perm)
    tv, order = torch.sort(tv, dim=1, descending=True, stable=True)
    ti = torch.gather(ti, 1, order)
    tied = (s >= tv[:, -1:]).sum(dim=1) > k
    for r in torch.nonzero(tied).flatten().tolist():
        sv, so = torch.sort(s[r], descending=True, stable=True)
        tv[r], ti[r] = sv[:k], so[:k]
    return tv, ti

