"""The numbers that decide ``correct``, and their limits.

A cell's check is a list of :class:`Check`: a short plain name, the number
read, and its limit; the run is correct when every number is finite and at
most its limit. The limits live in ``limits/<cell>.json``; the readings
they were set from are recorded beside them in ``PERF.md``.

- :func:`topk_numbers`: served top-k lists against the reference's exact
  top-k of the same query: ``rank_gap`` (the widest amount by which the
  reference's own score of a served hit lies below the reference's score at
  that rank), ``score_err`` (the widest gap between a served score and the
  reference's score of that hit), ``score_mse`` (the mean of its square).
- :func:`embedding_numbers`: served rows against the reference's rows of
  the same texts: the largest ``1 - cosine``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def checks_from(values: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """One Check per limit, in the limits' order; a number the run could not
    read counts as infinite."""
    return [Check(name, float(values.get(name, math.inf)), float(lim)) for name, lim in limits.items()]


def topk_numbers(served_scores: torch.Tensor, ref_vals: torch.Tensor, served_ref: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """``served_scores`` (B, k) as served, ``ref_vals`` (B, k) the reference's
    exact top-k scores, ``served_ref`` (B, k) the reference's scores of the
    served hits (-inf for an id outside the index); ``mask`` (B, k) the
    entries that count (lists shorter than k), all by default."""
    if mask is None:
        mask = torch.ones_like(ref_vals, dtype=torch.bool)
    zero = torch.zeros_like(ref_vals)
    gap = torch.where(mask, ref_vals - served_ref, zero)
    err = torch.where(mask, (served_scores - served_ref).abs(), zero)
    return {
        "rank_gap": float(gap.max()),
        "score_err": float(err.max()),
        "score_mse": float(err.pow(2).sum() / mask.sum()),
    }


def embedding_numbers(served: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """``served`` and ``ref`` (n, d) rows of the same texts."""
    s, r = served.to(torch.float32), ref.to(torch.float32)
    cos = (s * r).sum(dim=1) / (s.norm(dim=1) * r.norm(dim=1)).clamp_min(1e-30)
    return {"one_minus_cos": float((1.0 - cos).max())}
