"""On-device IR metrics for the fused search + eval path.

The fused alpha sweep scores its top-k output where it was computed, so the
host receives one metric dict per alpha instead of the runs. Relevance is
dense: ``rel_ids`` (B, R) integer row ids padded with -1 (binary relevance;
mMARCO qrels are binary). On binary qrels the metrics equal the host
evaluator's (:mod:`~codemix_dense_retrieval_torch.evals.metrics`) / 100; the
host path stays the one for graded relevance and confidence intervals.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def build_rel_matrix(rel_rows: Sequence[Sequence[int]], pad: int = -1) -> np.ndarray:
    """Ragged per-query relevant row-id lists -> (B, R) int32 padded."""
    width = max((len(r) for r in rel_rows), default=1) or 1
    out = np.full((len(rel_rows), width), pad, dtype=np.int32)
    for i, row in enumerate(rel_rows):
        out[i, : len(row)] = list(row)
    return out


def qrels_rel_matrix(
    qids: Sequence[str], qrels: Dict[str, Dict[str, int]], docids: Sequence[str]
) -> Tuple[np.ndarray, int]:
    """(rel_ids (B, R), extra_zero_queries) for :func:`topk_metrics`: each
    run query's positively judged docids as row ids of ``docids`` (docids
    that are not there are dropped: subset evaluation), and the number of
    qrels queries absent from the run with at least one such docid (the host
    evaluator scores them 0). Only the judged docids are looked up, so an
    index of millions of rows costs one pass with a set test, not a dict of
    every row."""
    wanted = {d for judged in qrels.values() for d, r in judged.items() if r > 0}
    row_of = {d: i for i, d in enumerate(docids) if d in wanted}
    rel = build_rel_matrix([
        [row_of[d] for d, r in qrels.get(qid, {}).items() if r > 0 and d in row_of] for qid in qids
    ])
    run_qids = set(qids)
    extra_zero = sum(
        1 for qid, judged in qrels.items()
        if qid not in run_qids and any(r > 0 and d in row_of for d, r in judged.items())
    )
    return rel, extra_zero


def topk_metrics(
    topk_ids: torch.Tensor,  # (B, k) global row ids
    rel_ids: torch.Tensor,   # (B, R), -1 padded
    cutoffs: Sequence[int] = (1, 3, 5, 10, 100),
    extra_zero_queries: int = 0,
) -> Dict[str, torch.Tensor]:
    """Binary-relevance RR/P/R/nDCG at the given cutoffs and AP, as f32
    scalars on the tensors' device, in 0..1 (callers scale x100).

    The mean runs over JUDGED queries, as the host evaluator's does: rows
    with no valid rel id are left out of the denominator, and
    ``extra_zero_queries`` adds the qrels queries absent from the run (the
    host path scores them 0)."""
    b, k = topk_ids.shape
    dev = topk_ids.device
    rel_ids = rel_ids.to(dev)
    valid_rel = rel_ids >= 0
    num_rel = valid_rel.sum(dim=1)
    judged = (num_rel > 0).to(torch.float32)
    denom = torch.clamp(judged.sum() + extra_zero_queries, min=1.0)

    def agg(per_query: torch.Tensor) -> torch.Tensor:
        return (per_query * judged).sum() / denom

    hits = ((topk_ids[:, :, None] == rel_ids[:, None, :]) & valid_rel[:, None, :]).any(dim=-1)
    ranks = torch.arange(1, k + 1, dtype=torch.float32, device=dev)[None, :]
    hits_f = hits.to(torch.float32)
    # reciprocal rank of the first hit (inf when none)
    first_rank = torch.where(hits, ranks, torch.inf).amin(dim=1)
    discounts = 1.0 / torch.log2(ranks + 1.0)
    csum = torch.cumsum(hits_f, dim=1)
    dcg_prefix = torch.cumsum(hits_f * discounts, dim=1)
    # the ideal DCG runs over the whole cutoff horizon, not the k retrieved:
    # nDCG@c with num_rel > k divides by the sum of min(num_rel, c) discounts
    c_max = max(max(cutoffs), k)
    ideal_prefix = torch.cumsum(
        1.0 / torch.log2(torch.arange(1, c_max + 1, dtype=torch.float32, device=dev) + 1.0), dim=0
    )
    num_rel_f = num_rel.to(torch.float32)
    out: Dict[str, torch.Tensor] = {}
    for c in cutoffs:
        c_eff = min(c, k)
        rr = torch.where(first_rank <= c_eff, 1.0 / first_rank, 0.0)
        out[f"RR@{c}"] = agg(rr)
        hits_at_c = csum[:, c_eff - 1]
        out[f"P@{c}"] = agg(hits_at_c / c)
        recall = torch.where(num_rel > 0, hits_at_c / torch.clamp(num_rel_f, min=1.0), 0.0)
        out[f"R@{c}"] = agg(recall)
        # binary nDCG@c: the ideal is the sum of the first min(num_rel, c) discounts
        ideal_n = torch.clamp(num_rel, 0, c)
        idcg = torch.where(ideal_n > 0, ideal_prefix[torch.clamp(ideal_n - 1, min=0)], 0.0)
        ndcg = torch.where(idcg > 0, dcg_prefix[:, c_eff - 1] / idcg, 0.0)
        out[f"nDCG@{c}"] = agg(ndcg)
    # AP over the k-truncated ranking (exact when k covers every retrieved doc)
    prec_at_rank = csum / ranks
    ap = (prec_at_rank * hits_f).sum(dim=1) / torch.clamp(num_rel_f, min=1.0)
    out["AP"] = agg(torch.where(num_rel > 0, ap, 0.0))
    return out
