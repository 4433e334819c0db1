"""IR metrics with trec_eval-compatible semantics.

- run ordering: score descending, ties broken by docid string DESCENDING
  (trec_eval's sort order);
- nDCG@k: linear gain ``rel``, discount ``log2(rank+1)``, ideal ranking
  over all judged docs;
- RR@k: reciprocal rank of the first doc with rel >= 1 inside the cutoff;
- P@k: relevant-in-top-k / k;  R@k: relevant-in-top-k / total-relevant;
- AP: mean of precision at each relevant retrieved rank, / total-relevant;
- aggregation: mean over every query present in the qrels (a query with no
  run rows contributes 0), scaled x100 by the caller.

Canonical names: ``nDCG@10``, ``RR@10``, ``P@10``, ``R@10``, ``AP``, with the
aliases ``MRR@10`` -> ``RR@10``, ``Recall@10`` -> ``R@10``, ``MAP`` -> ``AP``.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Qrels = Dict[str, Dict[str, int]]
# run: {qid: [(docid, score), ...]} in any order
Run = Dict[str, List[Tuple[str, float]]]


@dataclass(frozen=True)
class Measure:
    name: str  # canonical family: nDCG | RR | P | R | AP
    cutoff: Optional[int] = None

    def __str__(self) -> str:
        return f"{self.name}@{self.cutoff}" if self.cutoff is not None else self.name


_ALIASES = {
    "ndcg": "nDCG",
    "mrr": "RR",
    "rr": "RR",
    "p": "P",
    "precision": "P",
    "recall": "R",
    "r": "R",
    "map": "AP",
    "ap": "AP",
}


def parse_measure(token: str) -> Measure:
    tok = token.strip()
    if "@" in tok:
        fam, cut = tok.split("@", 1)
        cutoff: Optional[int] = int(cut)
    else:
        fam, cutoff = tok, None
    fam_l = fam.lower()
    if fam_l not in _ALIASES:
        raise ValueError(f"unknown measure {token!r}")
    name = _ALIASES[fam_l]
    if name == "AP" and cutoff is not None:
        raise ValueError(f"AP does not take a cutoff: {token!r}")
    if name != "AP" and cutoff is None:
        raise ValueError(f"measure {token!r} requires a cutoff")
    return Measure(name, cutoff)


def parse_measures(tokens: Iterable[str]) -> List[Measure]:
    """Parse and dedup (aliases collapse, e.g. AP+MAP -> one AP) keeping order."""
    seen: Dict[str, Measure] = {}
    for t in tokens:
        m = parse_measure(t)
        seen.setdefault(str(m), m)
    return list(seen.values())


def sort_run_rows(rows: Sequence[Tuple[str, float]]) -> List[Tuple[str, float]]:
    """trec_eval ordering: score desc, docid desc on ties."""
    return sorted(rows, key=lambda r: (-r[1], _desc_key(r[0])))


class _desc_key(str):
    """String wrapper that inverts lexicographic comparison."""

    __slots__ = ()

    def __lt__(self, other):  # type: ignore[override]
        return str.__gt__(self, other)


def _per_query(
    measures: Sequence[Measure],
    judged: Dict[str, int],
    rows: Sequence[Tuple[str, float]],
) -> Dict[str, float]:
    # pytrec_eval receives the run as {qid: {docid: score}} — a docid
    # repeated in the TREC file collapses to its LAST score (dict
    # assignment order). Scoring the raw rows would count a duplicated
    # relevant doc twice in P/R/AP; collapse identically first.
    ranked = sort_run_rows(list(dict(rows).items()))
    rels = [judged.get(docid, 0) for docid, _ in ranked]
    num_rel_total = sum(1 for r in judged.values() if r > 0)

    # ideal gains for nDCG (all judged docs, rel desc)
    ideal = sorted((r for r in judged.values() if r > 0), reverse=True)

    out: Dict[str, float] = {}
    for m in measures:
        k = m.cutoff
        if m.name == "nDCG":
            assert k is not None
            dcg = sum(rel / math.log2(i + 2) for i, rel in enumerate(rels[:k]) if rel > 0)
            idcg = sum(rel / math.log2(i + 2) for i, rel in enumerate(ideal[:k]))
            out[str(m)] = dcg / idcg if idcg > 0 else 0.0
        elif m.name == "RR":
            assert k is not None
            val = 0.0
            for i, rel in enumerate(rels[:k]):
                if rel > 0:
                    val = 1.0 / (i + 1)
                    break
            out[str(m)] = val
        elif m.name == "P":
            assert k is not None
            out[str(m)] = sum(1 for rel in rels[:k] if rel > 0) / k
        elif m.name == "R":
            assert k is not None
            hit = sum(1 for rel in rels[:k] if rel > 0)
            out[str(m)] = hit / num_rel_total if num_rel_total else 0.0
        elif m.name == "AP":
            if not num_rel_total:
                out[str(m)] = 0.0
                continue
            hits = 0
            ap = 0.0
            for i, rel in enumerate(rels):
                if rel > 0:
                    hits += 1
                    ap += hits / (i + 1)
            out[str(m)] = ap / num_rel_total
        else:  # pragma: no cover
            raise AssertionError(m)
    return out


def _t_multiplier(conf_level: float, n: int) -> float:
    """Two-tailed t critical value (scipy when available, normal fallback)."""
    if n < 2:
        return math.nan
    prob = 1 - (1 - conf_level) / 2
    try:
        from scipy import stats as _scipy_stats

        return float(_scipy_stats.t.ppf(prob, df=n - 1))
    except Exception:
        try:
            return statistics.NormalDist().inv_cdf(prob)
        except Exception:
            return math.nan


def ndcg_statistics(values: Sequence[float], mean: float) -> Optional[Dict[str, float]]:
    """std/stderr/CI90/CI95 over per-query nDCG values."""
    n = len(values)
    if n == 0:
        return None
    std = statistics.stdev(values) if n > 1 else 0.0
    se = std / math.sqrt(n) if n else math.nan

    def _ci(level: float) -> Tuple[float, float]:
        t_mult = _t_multiplier(level, n)
        if math.isnan(t_mult) or math.isnan(se):
            return (math.nan, math.nan)
        delta = t_mult * se
        return (mean - delta, mean + delta)

    ci90 = _ci(0.90)
    ci95 = _ci(0.95)
    return {
        "std": std,
        "stderr": se,
        "ci90_low": ci90[0],
        "ci90_high": ci90[1],
        "ci95_low": ci95[0],
        "ci95_high": ci95[1],
    }
