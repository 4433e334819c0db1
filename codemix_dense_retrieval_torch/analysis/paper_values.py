"""Paper-statistics calculator.

Replaces `calculate_paper_values.py` (#13): pure-python (stdlib + numpy
-free math) statistics over the collector's summary rows — delta
distributions, group splits, permutation tests (mean-diff, Spearman,
one-way ANOVA-F), and cluster bootstrap CIs (`:102-136,184-257`).

The statistical routines are exact behavioral matches of the reference's
(same resampling scheme, same p-value convention (more+1)/(n+1)); the
report section builder covers the full `paper_values.txt` structure:
input coverage, delta distribution, EN-in-index split, EN-as-strongest
-partner, bilingual indexing gains, endpoint alignment, peak-location
counts, per-metric delta sweeps, the EN-pair nDCG/recall nuance, headroom
Spearman, and the language-factor probes (typology/family/script/resource
with cluster-bootstrap CIs) — `calculate_paper_values.py:258-727`.
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from statistics import mean, median
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PERMUTATIONS = 5000
BOOTSTRAPS = 10000


def quantile(sorted_vals: Sequence[float], q: float) -> float:
    """Linear-interpolation quantile over a pre-sorted list (reference
    convention)."""
    n = len(sorted_vals)
    if n == 0:
        return float("nan")
    if n == 1:
        return float(sorted_vals[0])
    pos = q * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac)


def cluster_bootstrap_stats(
    clusters: Dict[str, List],
    stat_fn: Callable[[List], float],
    n_boot: int = BOOTSTRAPS,
    seed: int = 0,
) -> Tuple[float, float, float, int]:
    """Cluster bootstrap CI (resample clusters with replacement)."""
    all_records = [r for rs in clusters.values() for r in rs]
    obs = stat_fn(all_records)
    keys = list(clusters.keys())
    if not keys:
        return float("nan"), float("nan"), float("nan"), 0
    rng = random.Random(seed)
    samples = []
    for _ in range(n_boot):
        sampled_keys = [keys[rng.randrange(len(keys))] for _ in range(len(keys))]
        val = stat_fn([r for k in sampled_keys for r in clusters[k]])
        if not math.isnan(val):
            samples.append(val)
    samples.sort()
    return obs, quantile(samples, 0.025), quantile(samples, 0.975), len(samples)


def _rank(vals: Sequence[float]) -> List[float]:
    order = sorted(range(len(vals)), key=lambda i: vals[i])
    ranks = [0.0] * len(vals)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and vals[order[j + 1]] == vals[order[i]]:
            j += 1
        avg = (i + j) / 2 + 1
        for t in range(i, j + 1):
            ranks[order[t]] = avg
        i = j + 1
    return ranks


def spearman_rho(x: Sequence[float], y: Sequence[float]) -> float:
    if len(x) != len(y) or len(x) < 2:
        return float("nan")
    rx, ry = _rank(x), _rank(y)
    mx, my = mean(rx), mean(ry)
    num = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    dx = math.sqrt(sum((a - mx) ** 2 for a in rx))
    dy = math.sqrt(sum((b - my) ** 2 for b in ry))
    if dx == 0 or dy == 0:
        return float("nan")
    return num / (dx * dy)


def perm_spearman(
    x: Sequence[float], y: Sequence[float], n_perm: int = PERMUTATIONS, seed: int = 0
) -> Tuple[float, float]:
    obs = spearman_rho(x, y)
    rng = random.Random(seed)
    y_copy = list(y)
    more = 0
    for _ in range(n_perm):
        rng.shuffle(y_copy)
        if abs(spearman_rho(x, y_copy)) >= abs(obs):
            more += 1
    return obs, (more + 1) / (n_perm + 1)


def perm_mean_diff(
    groups: Dict[str, List[float]],
    a_label: Optional[str] = None,
    b_label: Optional[str] = None,
    n_perm: int = PERMUTATIONS,
    seed: int = 0,
) -> Tuple[float, float]:
    """Two-group permutation test for mean difference."""
    unique = list(groups.keys())
    if len(unique) != 2:
        return float("nan"), float("nan")
    if a_label is None or b_label is None:
        a_label, b_label = sorted(unique)
    labels = [g for g, vals in groups.items() for _ in vals]
    values = [v for vals in groups.values() for v in vals]

    def stat(lbls):
        a = [v for v, l in zip(values, lbls) if l == a_label]
        b = [v for v, l in zip(values, lbls) if l == b_label]
        if not a or not b:
            return float("nan")
        return mean(a) - mean(b)

    obs = stat(labels)
    rng = random.Random(seed)
    labels_copy = labels[:]
    more = 0
    for _ in range(n_perm):
        rng.shuffle(labels_copy)
        s = stat(labels_copy)
        if not math.isnan(s) and abs(s) >= abs(obs):
            more += 1
    return obs, (more + 1) / (n_perm + 1)


def anova_f(groups: Dict[str, List[float]]) -> float:
    all_vals = [v for vals in groups.values() for v in vals]
    if len(groups) < 2 or not all_vals:
        return float("nan")
    overall = mean(all_vals)
    ss_between = ss_within = 0.0
    for vals in groups.values():
        if not vals:
            continue
        m = mean(vals)
        ss_between += len(vals) * (m - overall) ** 2
        ss_within += sum((v - m) ** 2 for v in vals)
    df_between = len(groups) - 1
    df_within = len(all_vals) - len(groups)
    if df_within <= 0 or ss_within == 0:
        return float("nan")
    return (ss_between / df_between) / (ss_within / df_within)


def perm_anova(
    groups: Dict[str, List[float]], n_perm: int = PERMUTATIONS, seed: int = 0
) -> Tuple[float, float]:
    labels = [g for g, vals in groups.items() for _ in vals]
    values = [v for vals in groups.values() for v in vals]
    obs = anova_f(groups)
    rng = random.Random(seed)
    labels_copy = labels[:]
    more = 0
    for _ in range(n_perm):
        rng.shuffle(labels_copy)
        shuffled = defaultdict(list)
        for v, l in zip(values, labels_copy):
            shuffled[l].append(v)
        if anova_f(shuffled) >= obs:
            more += 1
    return obs, (more + 1) / (n_perm + 1)


def eta_squared(groups: Dict[str, List[float]]) -> float:
    all_vals = [v for vals in groups.values() for v in vals]
    if len(groups) < 2 or len(all_vals) < 2:
        return float("nan")
    overall = mean(all_vals)
    ss_total = sum((v - overall) ** 2 for v in all_vals)
    ss_between = sum(
        len(vals) * (mean(vals) - overall) ** 2 for vals in groups.values() if vals
    )
    if ss_total == 0:
        return float("nan")
    return ss_between / ss_total


def omega_squared(groups: Dict[str, List[float]]) -> float:
    """Bias-corrected effect size for a one-way layout
    (`calculate_paper_values.py:154-181` semantics)."""
    all_vals = [v for vals in groups.values() for v in vals]
    k = len([g for g in groups.values() if g])
    n = len(all_vals)
    if k < 2 or n <= k:
        return float("nan")
    overall = mean(all_vals)
    ss_total = sum((v - overall) ** 2 for v in all_vals)
    ss_between = sum(
        len(vals) * (mean(vals) - overall) ** 2 for vals in groups.values() if vals
    )
    ms_within = (ss_total - ss_between) / (n - k)
    denom = ss_total + ms_within
    if denom == 0:
        return float("nan")
    return (ss_between - (k - 1) * ms_within) / denom


# ---------------------------------------------------------------------------
# row helpers (summary rows from analysis.collect.compute_summary)
# ---------------------------------------------------------------------------

def _pair_langs(row: Dict) -> Tuple[str, str]:
    parts = str(row.get("pair") or "").lower().split("-")
    return (parts[0], parts[1]) if len(parts) == 2 else ("", "")


def _doc_info(row: Dict) -> Tuple[Optional[str], bool, bool]:
    """(doc_lang code | None, is_bilingual, en_in_index) for a row whose
    doc_side is a language name ("chinese") or "bilingual-a-b"."""
    from codemix_dense_retrieval_torch.io.naming import LANG_CODES

    side = str(row.get("doc_side") or "")
    if side.startswith("bilingual-"):
        langs = side.split("-")[1:]
        return None, True, "en" in langs
    code = LANG_CODES.get(side, side if len(side) == 2 else None)
    return code, False, code == "en"


def _regime(row: Dict) -> Optional[str]:
    """Reference doc-regime label: "L1 docs" | "L2 docs" | "L1+L2 docs"."""
    a, b = _pair_langs(row)
    doc_lang, is_bi, _ = _doc_info(row)
    if is_bi:
        return "L1+L2 docs"
    if doc_lang == a:
        return "L1 docs"
    if doc_lang == b:
        return "L2 docs"
    return None


def _is_en_pair(row: Dict) -> bool:
    return "en" in _pair_langs(row)


def _valid(x) -> bool:
    return x is not None and not (isinstance(x, float) and math.isnan(x))


# ---------------------------------------------------------------------------
# headline report over collector summary rows
# ---------------------------------------------------------------------------

def delta_distribution(summary_rows: List[Dict]) -> Dict[str, float]:
    """paper_values.txt:9-17 — delta(nDCG@10) distribution over groups."""
    deltas = [r["delta_ndcg"] for r in summary_rows if not math.isnan(r["delta_ndcg"])]
    if not deltas:
        return {}
    pos = sum(1 for d in deltas if d > 0)
    return {
        "n_groups": len(deltas),
        "delta_mean": mean(deltas),
        "delta_median": median(deltas),
        "delta_max": max(deltas),
        "delta_min": min(deltas),
        "frac_positive": pos / len(deltas),
        "n_positive": pos,
    }


def en_absent_split(summary_rows: List[Dict]) -> Dict[str, Dict[str, float]]:
    """paper_values.txt:22-24 — delta stats split by whether EN documents
    are in the searched index."""
    def has_en(row) -> bool:
        side = str(row.get("doc_side") or "")
        return side == "english" or (side.startswith("bilingual-") and "en" in side.split("-")[1:])

    groups: Dict[str, List[float]] = {"en_in_index": [], "en_absent": []}
    for r in summary_rows:
        if math.isnan(r["delta_ndcg"]):
            continue
        groups["en_in_index" if has_en(r) else "en_absent"].append(r["delta_ndcg"])
    out = {}
    for name, vals in groups.items():
        if vals:
            out[name] = {
                "n": len(vals),
                "mean": mean(vals),
                "frac_positive": sum(1 for v in vals if v > 0) / len(vals),
            }
    return out


def peak_lambda_counts(summary_rows: List[Dict]) -> Dict[float, int]:
    counts: Dict[float, int] = defaultdict(int)
    for r in summary_rows:
        lam = r.get("lambda_star_mid")
        if lam is not None and not math.isnan(lam):
            counts[float(lam)] += 1
    return dict(sorted(counts.items()))


def input_coverage(summary_rows: List[Dict]) -> Dict[str, object]:
    """Pairs having all three doc regimes (L1, L2, L1+L2) — the reference's
    validity filter (`calculate_paper_values.py:303-316`)."""
    regs: Dict[str, set] = defaultdict(set)
    for r in summary_rows:
        reg = _regime(r)
        if reg and r.get("pair"):
            regs[str(r["pair"])].add(reg)
    full = {"L1 docs", "L2 docs", "L1+L2 docs"}
    valid = sorted(p for p, s in regs.items() if full.issubset(s))
    missing = sorted(p for p in regs if p not in valid)
    return {"valid_pairs": valid, "missing_pairs": missing}


def en_best_partner(summary_rows: List[Dict]) -> Dict[str, object]:
    """Finding 2: for each non-EN doc language over monolingual-doc rows,
    is EN the partner with the largest delta(nDCG@10)?
    (`calculate_paper_values.py:384-415`)."""
    doc_partner: Dict[str, Dict[str, float]] = defaultdict(dict)
    for r in summary_rows:
        doc_lang, is_bi, _ = _doc_info(r)
        if is_bi or not doc_lang or not _valid(r.get("delta_ndcg")):
            continue
        a, b = _pair_langs(r)
        partner = b if doc_lang == a else a
        if partner:
            doc_partner[doc_lang][partner] = r["delta_ndcg"]
    per_doc: Dict[str, Dict[str, object]] = {}
    en_best = en_total = 0
    for dl in sorted(doc_partner):
        if dl == "en" or "en" not in doc_partner[dl]:
            continue
        partners = doc_partner[dl]
        en_total += 1
        non_en = sorted(
            ((p, v) for p, v in partners.items() if p != "en"),
            key=lambda x: x[1], reverse=True,
        )
        is_best = max(partners.items(), key=lambda x: x[1])[0] == "en"
        en_best += is_best
        per_doc[dl] = {
            "en_delta": partners["en"],
            "best_non_en": non_en[0] if non_en else None,
            "en_is_best": is_best,
        }
    return {"per_doc_lang": per_doc, "en_best": en_best, "en_total": en_total}


def bilingual_gains(summary_rows: List[Dict]) -> Dict[str, Dict[str, float]]:
    """Finding 4: gain = best_mixed(L1+L2 docs) - max(best_mixed(L1),
    best_mixed(L2)), split by EN vs non-EN pairs
    (`calculate_paper_values.py:317-372`)."""
    by_pair: Dict[str, Dict[str, float]] = defaultdict(dict)
    for r in summary_rows:
        reg = _regime(r)
        if reg and r.get("pair") and _valid(r.get("best_mixed_ndcg")):
            by_pair[str(r["pair"])][reg] = r["best_mixed_ndcg"]
    buckets: Dict[str, List[float]] = {"en_pairs": [], "non_en_pairs": []}
    for pair, reg in by_pair.items():
        if not {"L1 docs", "L2 docs", "L1+L2 docs"}.issubset(reg):
            continue
        gain = reg["L1+L2 docs"] - max(reg["L1 docs"], reg["L2 docs"])
        key = "en_pairs" if "en" in pair.lower().split("-") else "non_en_pairs"
        buckets[key].append(gain)
    out = {}
    for name, vals in buckets.items():
        if vals:
            out[name] = {
                "n": len(vals),
                "mean": mean(vals),
                "gains_gt0": sum(1 for v in vals if v > 0),
                "gains_gt0p1": sum(1 for v in vals if v > 0.1),
            }
    return out


def endpoint_alignment(rows: List[Dict]) -> Dict[str, int]:
    """Finding 3: on a monolingual index, the endpoint whose query language
    matches the document language should beat the opposite endpoint
    (`calculate_paper_values.py:478-520`). ``rows`` are LONG collector
    rows (one per mix_ratio) — lambda=0 is the pure-qa endpoint."""
    groups: Dict[Tuple, Dict[float, float]] = defaultdict(dict)
    meta: Dict[Tuple, Dict] = {}
    for r in rows:
        doc_lang, is_bi, _ = _doc_info(r)
        if is_bi or not doc_lang or not _valid(r.get("ndcg10")):
            continue
        key = (r.get("pair"), r.get("doc_side"), r.get("mix_mode"), r.get("model"))
        ratio = float(r["mix_ratio"])
        if ratio in (0.0, 100.0):
            groups[key][ratio] = r["ndcg10"]
            meta[key] = r
    better = worse = ties = missing = 0
    violations = []
    for key, eps in groups.items():
        if 0.0 not in eps or 100.0 not in eps:
            missing += 1
            continue
        r = meta[key]
        a, b = _pair_langs(r)
        doc_lang, _, _ = _doc_info(r)
        if doc_lang == a:
            match_val, opp_val = eps[0.0], eps[100.0]
        elif doc_lang == b:
            match_val, opp_val = eps[100.0], eps[0.0]
        else:
            missing += 1
            continue
        if match_val > opp_val:
            better += 1
        elif match_val < opp_val:
            worse += 1
            violations.append(key)
        else:
            ties += 1
    return {
        "n": len(groups), "match_better": better, "match_worse": worse,
        "ties": ties, "missing": missing, "violations": violations,
    }


METRIC_SWEEP_KEYS = ("ndcg10", "mrr10", "recall10")


def metric_delta_sweep(rows: List[Dict]) -> Dict[str, object]:
    """Per-metric best-interior-minus-best-endpoint deltas over LONG rows
    plus the EN-pair nuance (delta nDCG<0 but delta R@10>0 only happens on
    EN pairs with EN in the index) — `calculate_paper_values.py:425-476,
    584-607`."""
    groups: Dict[Tuple, List[Dict]] = defaultdict(list)
    for r in rows:
        if _valid(r.get("ndcg10")) and _valid(r.get("mix_ratio")):
            groups[(r.get("pair"), r.get("doc_side"), r.get("mix_mode"),
                    r.get("model"))].append(r)
    deltas_by_metric: Dict[str, List[float]] = {m: [] for m in METRIC_SWEEP_KEYS}
    delta_by_setting: Dict[Tuple, Dict[str, float]] = defaultdict(dict)
    for key, grp in groups.items():
        endpoints = [g for g in grp if float(g["mix_ratio"]) in (0.0, 100.0)]
        interior = [g for g in grp if 0.0 < float(g["mix_ratio"]) < 100.0]
        for m in METRIC_SWEEP_KEYS:
            ep_vals = [g[m] for g in endpoints if _valid(g.get(m))]
            mid_vals = [g[m] for g in interior if _valid(g.get(m))]
            if not mid_vals:
                delta = 0.0
            else:
                delta = max(mid_vals) - (max(ep_vals) if ep_vals else 0.0)
            deltas_by_metric[m].append(delta)
            delta_by_setting[key][m] = delta
    per_metric = {}
    for m, vals in deltas_by_metric.items():
        if vals:
            per_metric[m] = {
                "mean": mean(vals),
                "pos": sum(1 for v in vals if v > 0),
                "neg": sum(1 for v in vals if v < 0),
                "zero": sum(1 for v in vals if abs(v) < 1e-12),
                "n": len(vals),
            }
    # EN-pair nuance: every (ndcg<0, r10>0) setting should be an EN pair
    # with EN in the index
    nuance, violations = [], []
    for key, d in delta_by_setting.items():
        nd, rr = d.get("ndcg10"), d.get("recall10")
        if nd is None or rr is None or not (nd < 0 and rr > 0):
            continue
        nuance.append(key)
        row = {"pair": key[0], "doc_side": key[1]}
        _, _, en_in_index = _doc_info(row)
        if not (_is_en_pair(row) and en_in_index):
            violations.append(key)
    return {
        "per_metric": per_metric,
        "nuance_settings": nuance,
        "nuance_violations": violations,
    }


def headroom_spearman(summary_rows: List[Dict]) -> Dict[str, Dict[str, float]]:
    """Headroom effect: Spearman rho between best-endpoint nDCG and delta,
    for all settings / EN pairs / EN-absent indexes
    (`calculate_paper_values.py:608-625`)."""
    def rho_of(rows: List[Dict]) -> Dict[str, float]:
        pts = [
            (r["best_endpoint_ndcg"], r["delta_ndcg"]) for r in rows
            if _valid(r.get("best_endpoint_ndcg")) and _valid(r.get("delta_ndcg"))
        ]
        if len(pts) < 2:
            return {"n": len(pts), "rho": float("nan")}
        x, y = zip(*pts)
        return {"n": len(pts), "rho": spearman_rho(list(x), list(y))}

    return {
        "all": rho_of(summary_rows),
        "en_pairs": rho_of([r for r in summary_rows if _is_en_pair(r)]),
        "en_absent_index": rho_of(
            [r for r in summary_rows if not _doc_info(r)[2]]
        ),
    }


def language_factor_probes(
    summary_rows: List[Dict], n_boot: int = 2000
) -> Dict[str, object]:
    """Typology / family / script / resource probes on the controlled
    subset (non-EN pairs, monolingual docs), cluster-bootstrapped by pair
    (`calculate_paper_values.py:626-727`). Factor columns come from
    analysis.lang_factors via the collector."""
    controlled = [
        r for r in summary_rows
        if r.get("pair") and not _is_en_pair(r) and not _doc_info(r)[1]
        and _valid(r.get("delta_ndcg"))
    ]
    out: Dict[str, object] = {"n_settings": len(controlled)}
    if not controlled:
        return out
    by_pair: Dict[str, List[Dict]] = defaultdict(list)
    for r in controlled:
        by_pair[str(r["pair"])].append(r)
    out["n_pairs"] = len(by_pair)

    def stat_spearman(key: str):
        def stat(records: List[Dict]) -> float:
            pts = [
                (r[key], r["delta_ndcg"]) for r in records
                if _valid(r.get(key)) and float(r.get(key, -1)) >= 0
            ]
            if len(pts) < 2:
                return float("nan")
            x, y = zip(*pts)
            return spearman_rho(list(x), list(y))
        return stat

    for key, label in (("lang2vec_knn", "typology_lang2vec"),
                       ("glot_tree", "family_glot_tree")):
        if any(_valid(r.get(key)) for r in controlled):
            rho, lo, hi, n_ok = cluster_bootstrap_stats(
                by_pair, stat_spearman(key), n_boot=n_boot
            )
            out[label] = {"rho": rho, "ci95": (lo, hi), "n_boot": n_ok}

    def as_bool(v) -> Optional[bool]:
        if isinstance(v, bool):
            return v
        if isinstance(v, str):
            return {"true": True, "false": False}.get(v.lower())
        return None

    def stat_script_diff(records: List[Dict]) -> float:
        match = [r["delta_ndcg"] for r in records if as_bool(r.get("same_script")) is True]
        mismatch = [r["delta_ndcg"] for r in records if as_bool(r.get("same_script")) is False]
        if not match or not mismatch:
            return float("nan")
        return mean(match) - mean(mismatch)

    if any(as_bool(r.get("same_script")) is not None for r in controlled):
        diff, lo, hi, n_ok = cluster_bootstrap_stats(
            by_pair, stat_script_diff, n_boot=n_boot
        )
        out["script_match_minus_mismatch"] = {
            "diff": diff, "ci95": (lo, hi), "n_boot": n_ok,
        }

    def resource_groups(records: List[Dict]) -> Dict[str, List[float]]:
        groups: Dict[str, List[float]] = defaultdict(list)
        for r in records:
            if _valid(r.get("min_resource")):
                groups[str(r["min_resource"])].append(r["delta_ndcg"])
        return groups

    groups = resource_groups(controlled)
    if len(groups) >= 2:
        e2, lo, hi, n_ok = cluster_bootstrap_stats(
            by_pair, lambda recs: eta_squared(resource_groups(recs)), n_boot=n_boot
        )
        out["resource_eta2"] = {"value": e2, "ci95": (lo, hi), "n_boot": n_ok}
        w2, lo, hi, n_ok = cluster_bootstrap_stats(
            by_pair, lambda recs: omega_squared(resource_groups(recs)), n_boot=n_boot
        )
        out["resource_omega2"] = {"value": w2, "ci95": (lo, hi), "n_boot": n_ok}

        def stat_resource_rho(records: List[Dict]) -> float:
            pts = [
                (float(r["min_resource"]), r["delta_ndcg"]) for r in records
                if _valid(r.get("min_resource"))
            ]
            if len(pts) < 2:
                return float("nan")
            x, y = zip(*pts)
            return spearman_rho(list(x), list(y))

        rho, lo, hi, n_ok = cluster_bootstrap_stats(
            by_pair, stat_resource_rho, n_boot=n_boot
        )
        out["resource_index_rho"] = {"rho": rho, "ci95": (lo, hi), "n_boot": n_ok}
    return out


def _section(title: str) -> List[str]:
    bar = "=" * len(title)
    return ["", bar, title, bar]


def paper_values_report(
    summary_rows: List[Dict],
    rows: Optional[List[Dict]] = None,
    n_boot: int = 2000,
) -> str:
    """Full paper-values report. ``summary_rows`` are the collector's
    processed rows; ``rows`` (optional) are the long per-mix-ratio rows,
    enabling the endpoint-alignment and per-metric sweep sections."""
    lines = ["# paper values"]

    cov = input_coverage(summary_rows)
    lines += _section("Input coverage")
    lines.append(f"Pairs with full regimes (L1, L2, L1+L2): {len(cov['valid_pairs'])}")
    lines.append(f"Pairs missing regimes: {len(cov['missing_pairs'])}")

    dd = delta_distribution(summary_rows)
    if dd:
        lines += _section("Global picture: delta distribution (nDCG@10)")
        lines += [
            f"groups: {dd['n_groups']}",
            f"delta(nDCG@10) mean: {dd['delta_mean']:+.4f}",
            f"delta(nDCG@10) median: {dd['delta_median']:+.4f}",
            f"delta > 0 in {dd['n_positive']}/{dd['n_groups']} groups",
            f"range: {dd['delta_min']:+.4f} to {dd['delta_max']:+.4f}",
            f"max gain: {dd['delta_max']:+.4f}",
        ]

    split = en_absent_split(summary_rows)
    if split:
        lines += _section("Finding 1: English in index split")
        for name, stats in split.items():
            lines.append(
                f"{name}: n={stats['n']} mean={stats['mean']:+.4f} "
                f"frac>0={stats['frac_positive']:.2f}"
            )

    ebp = en_best_partner(summary_rows)
    if ebp["en_total"]:
        lines += _section("Finding 2: English as strongest partner (monolingual docs)")
        for dl, info in ebp["per_doc_lang"].items():
            best_non = info["best_non_en"]
            non_str = (
                f", best_nonEN={best_non[0].upper()} {best_non[1]:.4f}" if best_non else ""
            )
            lines.append(
                f"{dl.upper()} docs: EN {info['en_delta']:.4f}{non_str}, "
                f"EN_is_best={info['en_is_best']}"
            )
        lines.append(f"EN best among partners: {ebp['en_best']}/{ebp['en_total']}")

    gains = bilingual_gains(summary_rows)
    if gains:
        lines += _section("Finding 4: Bilingual indexing gains (best_mixed_ndcg)")
        for name, g in gains.items():
            lines.append(
                f"{name}: n={g['n']} mean={g['mean']:+.4f} "
                f"gains>0={g['gains_gt0']} gains>0.1={g['gains_gt0p1']}"
            )

    if rows:
        align = endpoint_alignment(rows)
        lines += _section("Finding 3: Monolingual endpoint alignment (nDCG@10)")
        lines.append(f"Monolingual settings: {align['n']}")
        lines.append(
            f"Match endpoint better: {align['match_better']}, worse: "
            f"{align['match_worse']}, ties: {align['ties']}, missing: {align['missing']}"
        )

    lines += _section("Finding 3: Peak location counts (nDCG@10)")
    lines.append("peak lambda* counts: " + ", ".join(
        f"{lam:g}%:{cnt}" for lam, cnt in peak_lambda_counts(summary_rows).items()
    ))

    if rows:
        sweep = metric_delta_sweep(rows)
        lines += _section("Mixing effects across metrics (delta = best interior - best endpoint)")
        labels = {"ndcg10": "nDCG@10", "mrr10": "MRR@10", "recall10": "Recall@10"}
        for m, s in sweep["per_metric"].items():
            lines.append(
                f"{labels.get(m, m)}: mean={s['mean']:+.4f} +={s['pos']} "
                f"-={s['neg']} =0 {s['zero']} n={s['n']}"
            )
        lines += _section("EN-pair nuance: delta nDCG<0 but delta R@10>0")
        lines.append(f"Settings with ndcg<0 & r10>0: {len(sweep['nuance_settings'])}")
        lines.append(
            f"Subset check (EN pairs + EN in index): violations="
            f"{len(sweep['nuance_violations'])}"
        )

    hs = headroom_spearman(summary_rows)
    lines += _section("Headroom effect (Spearman rho: best endpoint vs delta)")
    for name, s in hs.items():
        lines.append(f"{name}: n={s['n']} rho={s['rho']:.3f}")

    probes = language_factor_probes(summary_rows, n_boot=n_boot)
    lines += _section("Language factor probes (controlled subset)")
    lines.append(f"Settings={probes.get('n_settings', 0)}")
    for key in ("typology_lang2vec", "family_glot_tree"):
        if key in probes:
            p = probes[key]
            lines.append(
                f"{key}: rho={p['rho']:.3f}, 95% CI "
                f"[{p['ci95'][0]:.3f}, {p['ci95'][1]:.3f}], n_boot={p['n_boot']}"
            )
    if "script_match_minus_mismatch" in probes:
        p = probes["script_match_minus_mismatch"]
        lines.append(
            f"script mean diff (match - mismatch): {p['diff']:.4f}, 95% CI "
            f"[{p['ci95'][0]:.4f}, {p['ci95'][1]:.4f}], n_boot={p['n_boot']}"
        )
    for key in ("resource_eta2", "resource_omega2"):
        if key in probes:
            p = probes[key]
            lines.append(
                f"{key}: {p['value']:.3f}, 95% CI "
                f"[{p['ci95'][0]:.3f}, {p['ci95'][1]:.3f}], n_boot={p['n_boot']}"
            )
    if "resource_index_rho" in probes:
        p = probes["resource_index_rho"]
        lines.append(
            f"resource index Spearman rho: {p['rho']:.3f}, 95% CI "
            f"[{p['ci95'][0]:.3f}, {p['ci95'][1]:.3f}], n_boot={p['n_boot']}"
        )
    return "\n".join(lines) + "\n"
