"""Results collector — aggregates eval-artifact trees into tidy CSVs.

Replaces `collect_results.py` / `collect_ablation_results.py` (#11/#12):
walks ``<results_root>/**``, parses experiment directory names
(`collect_results.py:234-274` semantics via ``io.naming``), keeps only
the LATEST timestamped agg per run stem (`:568-579`), extracts metric
means, and emits:

- a long-form CSV (one row per (experiment, mix_mode, band/alpha)), and
- a summary CSV with best-endpoint vs best-interior delta(nDCG@10) and
  lambda* per (pair, doc side) (`compute_full_summary`, `:362-403`).
"""

from __future__ import annotations

import json
import math
import pathlib
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from codemix_dense_retrieval_torch.io.naming import parse_eval_stem, parse_experiment_dirname
from codemix_dense_retrieval_torch.utils.logging import get_logger

log = get_logger("collect")

_ALPHA_RE = re.compile(r"^cm-alpha-(?P<alpha>[0-9.]+)(?:_base|_raw)?$")
_BAND_RE = re.compile(r"^cm(?P<lo>\d+)(?:-(?P<hi>\d+))?(?:_base|_raw)?$")


def mix_ratio_from_runstem(stem: str) -> Optional[Tuple[str, float]]:
    """(mix_mode, ratio 0..100) from a run stem.

    ``cm-alpha-0.5`` -> ("embed", 50.0); ``cm40-60`` -> ("word", 50.0)
    (band midpoint); ``cm0``/``cm100`` -> ("word", 0/100).
    """
    m = _ALPHA_RE.match(stem)
    if m:
        return "embed", float(m.group("alpha")) * 100.0
    m = _BAND_RE.match(stem)
    if m:
        lo = int(m.group("lo"))
        hi = int(m.group("hi")) if m.group("hi") else lo
        return "word", (lo + hi) / 2.0
    return None


def doc_mix_label(exp) -> str:
    """The reference's human doc-side label (`collect_results.py:171-183`):
    ``bilingual-ar-zh`` -> "AR + ZH docs" (pair order), mono language name
    -> "AR docs"."""
    if exp.is_bilingual:
        langs = exp.doc_side.split("-")[1:]
        return " + ".join(l.upper() for l in langs) + " docs"
    (code,) = exp.doc_langs
    return f"{code.upper()} docs"


# agg.json metric key -> reference export column (`collect_results.py:142-158`)
_REF_METRIC_COLS = {
    "nDCG@10": "ndcg10",
    "nDCG@10_std": "ndcg10_std",
    "nDCG@10_stderr": "ndcg10_stderr",
    "nDCG@10_ci90_low": "ndcg10_ci90_low",
    "nDCG@10_ci90_high": "ndcg10_ci90_high",
    "nDCG@10_ci95_low": "ndcg10_ci95_low",
    "nDCG@10_ci95_high": "ndcg10_ci95_high",
    "RR@10": "mrr10",
    "R@10": "r10",
}


def collect_results(results_root) -> List[Dict]:
    """Walk the tree; one row per latest agg.json."""
    root = pathlib.Path(results_root)
    # latest-timestamp dedup per (dir, runstem, split)
    latest: Dict[Tuple[str, str, str], Tuple[str, pathlib.Path]] = {}
    for agg in root.rglob("*-agg.json"):
        stem = agg.name[: -len("-agg.json")]
        parsed = parse_eval_stem(stem)
        if not parsed:
            continue
        runstem, split, ts = parsed
        key = (str(agg.parent), runstem, split)
        if key not in latest or ts > latest[key][0]:
            latest[key] = (ts, agg)

    rows: List[Dict] = []
    for (parent, runstem, split), (ts, agg) in sorted(latest.items()):
        # find the experiment dir walking up (vector_mix subdirs etc.)
        exp = None
        for p in [pathlib.Path(parent)] + list(pathlib.Path(parent).parents):
            exp = parse_experiment_dirname(p.name)
            if exp:
                break
        if exp is None:
            # unparseable experiment dir (e.g. the ablation2 subtree's
            # block-tagged names): the reference collector prunes these
            # (`collect_results.py:620-626`); the ablation collector owns
            # them
            continue
        mix = mix_ratio_from_runstem(runstem)
        if mix is None:
            continue
        mix_mode, ratio = mix
        try:
            metrics = json.loads(agg.read_text())
        except (OSError, json.JSONDecodeError) as e:
            log.warning("skipping unreadable %s: %s", agg, e)
            continue
        # vector_mix subdir forces embed mode (reference dir layout)
        if pathlib.Path(parent).name == "vector_mix":
            mix_mode = "embed"
        # source_file points at the sibling agg CSV when present (the
        # reference collector reads the CSVs, `collect_results.py:662`)
        src = agg.with_name(agg.name[: -len(".json")] + ".csv")
        if not src.exists():
            src = agg
        try:
            source_file = str(src.relative_to(root))
        except ValueError:
            source_file = str(src)
        row = {
            "experiment": exp.dirname(),
            "dataset": exp.dataset,
            "docs_size": exp.size,
            "doc_side": exp.doc_side,
            "doc_mix": doc_mix_label(exp),
            "pair": f"{exp.qa.upper()}-{exp.qb.upper()}",
            "model": exp.encoder_tag,
            "split": split,
            "run": runstem,
            "mix_mode": mix_mode,
            "mix_ratio": ratio,
            "timestamp": ts,
            "source_file": source_file,
            "ndcg10": metrics.get("nDCG@10"),
            "mrr10": metrics.get("RR@10"),
            "recall10": metrics.get("R@10"),
            "recall100": metrics.get("R@100"),
            "map": metrics.get("AP"),
        }
        for key, col in _REF_METRIC_COLS.items():
            if col not in ("ndcg10", "mrr10", "r10"):
                row[col] = metrics.get(key)
        # approx-tier audit trail: runs produced with --approx leave a
        # per-run meta with the certificate rate; surface it in the
        # NATIVE schema only (reference_format_rows projects a fixed
        # column set, so the byte-parity CSVs are unaffected)
        for stem in (runstem, runstem.removesuffix("_base")):
            meta_path = pathlib.Path(parent) / f"{stem}_meta.json"
            if not meta_path.exists():
                continue
            try:
                meta = json.loads(meta_path.read_text())
            except (OSError, json.JSONDecodeError):
                break
            if "certified_frac" in meta:
                row["certified_frac"] = meta["certified_frac"]
                row["approx"] = meta.get("approx", "fast")
            break
        perquery = load_perquery_ndcg10(agg)
        if perquery:
            row["perquery"] = perquery
        rows.append(row)
    return rows


def load_perquery_ndcg10(agg_json_path: pathlib.Path) -> Optional[Dict[str, float]]:
    """Per-query nDCG@10 series from the sibling -perquery.csv (written by
    the evaluator with --perquery); None when absent."""
    stem = agg_json_path.name[: -len("-agg.json")]
    pq = agg_json_path.parent / f"{stem}-perquery.csv"
    if not pq.exists():
        return None
    import csv

    out: Dict[str, float] = {}
    with open(pq, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        if "nDCG@10" not in (reader.fieldnames or []):
            return None
        for row in reader:
            try:
                out[row["qid"]] = float(row["nDCG@10"])
            except (ValueError, KeyError):
                continue
    return out or None


def bootstrap_delta_ci(
    endpoint_series: Dict[str, float],
    interior_series: Dict[str, float],
    n_boot: int = 2000,
    seed: int = 0,
) -> Optional[Dict[str, float]]:
    """Cluster (per-query) bootstrap CI for delta(nDCG@10) between the best
    interior and best endpoint runs (reference `collect_results.py:490-566`
    semantics: resample qids, recompute the mean difference)."""
    import random

    qids = sorted(set(endpoint_series) & set(interior_series))
    if len(qids) < 2:
        return None
    diffs = [interior_series[q] - endpoint_series[q] for q in qids]
    rng = random.Random(seed)
    n = len(diffs)
    samples = sorted(
        sum(diffs[rng.randrange(n)] for _ in range(n)) / n for _ in range(n_boot)
    )

    def q(p: float) -> float:
        pos = p * (len(samples) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(samples) - 1)
        return samples[lo] * (1 - pos + lo) + samples[hi] * (pos - lo)

    return {
        "delta_ndcg_ci90_low": q(0.05),
        "delta_ndcg_ci90_high": q(0.95),
        "delta_ndcg_ci95_low": q(0.025),
        "delta_ndcg_ci95_high": q(0.975),
    }


def compute_summary(rows: List[Dict]) -> List[Dict]:
    """Best-endpoint vs best-interior delta and lambda* per
    (pair, doc_side, mix_mode, model). When rows carry ``perquery``
    series (dict qid -> nDCG@10), a cluster-bootstrap CI over the
    best-interior-minus-best-endpoint per-query differences is added."""
    groups: Dict[Tuple, List[Dict]] = defaultdict(list)
    for r in rows:
        if r["ndcg10"] is None:
            continue
        groups[(r["pair"], r["doc_side"], r["mix_mode"], r["model"])].append(r)
    out: List[Dict] = []
    for (pair, doc_side, mix_mode, model), grp in sorted(
        groups.items(), key=lambda kv: tuple(str(x) for x in kv[0])
    ):
        endpoints = [g for g in grp if g["mix_ratio"] in (0.0, 100.0)]
        interior = [g for g in grp if 0.0 < g["mix_ratio"] < 100.0]
        best_endpoint = max((g["ndcg10"] for g in endpoints), default=math.nan)
        best_endpoint_row = (
            max(endpoints, key=lambda g: g["ndcg10"]) if endpoints else None
        )
        if interior:
            best = max(interior, key=lambda g: g["ndcg10"])
            best_mixed = best["ndcg10"]
            lambda_star = best["mix_ratio"]
            delta = best_mixed - (best_endpoint if not math.isnan(best_endpoint) else 0.0)
        else:
            best, best_mixed, lambda_star, delta = None, math.nan, math.nan, 0.0
        row_out = {
            "pair": pair,
            "doc_side": doc_side,
            "mix_mode": mix_mode,
            "model": model,
            "best_endpoint_ndcg": best_endpoint,
            "best_mixed_ndcg": best_mixed,
            "delta_ndcg": delta,
            "lambda_star_mid": lambda_star,
            "n_points": len(grp),
        }
        if (
            best is not None
            and best_endpoint_row is not None
            and isinstance(best.get("perquery"), dict)
            and isinstance(best_endpoint_row.get("perquery"), dict)
        ):
            ci = bootstrap_delta_ci(best_endpoint_row["perquery"], best["perquery"])
            if ci:
                row_out.update(ci)
        if pair:
            from codemix_dense_retrieval_torch.analysis.lang_factors import pair_factors

            row_out.update(pair_factors(str(pair)))
        out.append(row_out)
    return out


REFERENCE_EXPORT_COLUMNS = [
    "pair", "doc_mix", "method", "mix_ratio",
    "ndcg10", "ndcg10_std", "ndcg10_stderr",
    "ndcg10_ci90_low", "ndcg10_ci90_high",
    "ndcg10_ci95_low", "ndcg10_ci95_high",
    "mrr10", "r10", "model", "source_file",
]


def reference_format_rows(rows: List[Dict]) -> List[Dict]:
    """Rows in the reference's ``full_mmarco_results.csv`` vocabulary
    (`collect_results.py:142-158`): metrics x100 rounded to 4 decimals,
    ``method``/``doc_mix``/``source_file`` columns, sorted by
    (pair, doc_mix, method, mix_ratio, model, source_file)."""
    out: List[Dict] = []
    for r in rows:
        if r.get("ndcg10") is None:
            continue
        ref = {
            "pair": r["pair"],
            "doc_mix": r.get("doc_mix"),
            "method": r["mix_mode"],
            "mix_ratio": r["mix_ratio"],
            "model": r["model"],
            "source_file": r.get("source_file"),
        }
        scaled = {
            "ndcg10": r.get("ndcg10"), "mrr10": r.get("mrr10"),
            "r10": r.get("recall10"),
        }
        for col in REFERENCE_EXPORT_COLUMNS:
            if col.startswith("ndcg10_"):
                scaled[col] = r.get(col)
        for col, v in scaled.items():
            ref[col] = round(v * 100.0, 4) if v is not None else None
        out.append(ref)
    out.sort(key=lambda r: (
        str(r["pair"]), str(r["doc_mix"]), str(r["method"]),
        float(r["mix_ratio"]), str(r["model"]), str(r["source_file"]),
    ))
    return [{c: r.get(c) for c in REFERENCE_EXPORT_COLUMNS} for r in out]


def compute_reference_summary(rows: List[Dict]) -> List[Dict]:
    """The reference's processed summary (`compute_full_summary`,
    `collect_results.py:362-403`): group by (pair, doc_mix) on the
    x100-scaled nDCG@10, best endpoint (ratio 0/100) vs best interior,
    delta, lambda*, plus the pair-factor / doc-regime columns of
    ``full_mmarco_processed_results.csv``."""
    from codemix_dense_retrieval_torch.analysis.lang_factors import (
        reference_pair_factors,
    )

    ref_rows = reference_format_rows(rows)
    groups: Dict[Tuple[str, str], List[Dict]] = defaultdict(list)
    for r in ref_rows:
        if r["ndcg10"] is not None:
            groups[(r["pair"], r["doc_mix"])].append(r)
    out: List[Dict] = []
    for (pair, doc_mix), grp in sorted(groups.items()):
        endpoints = [g for g in grp if g["mix_ratio"] in (0.0, 100.0)]
        interior = [g for g in grp if 0.0 < g["mix_ratio"] < 100.0]
        best_endpoint = max((g["ndcg10"] for g in endpoints), default=math.nan)
        if interior:
            best = max(interior, key=lambda g: g["ndcg10"])
            best_mixed = best["ndcg10"]
            lambda_star = best["mix_ratio"]
            delta = best_mixed - (
                best_endpoint if not math.isnan(best_endpoint) else 0.0
            )
        else:
            best_mixed, lambda_star, delta = math.nan, math.nan, 0.0
        row = {
            "pair": pair,
            "doc_mix": doc_mix,
            "best_endpoint_ndcg": best_endpoint,
            "best_mixed_ndcg": best_mixed,
            "delta_ndcg": delta,
            "lambda_star_mid": lambda_star,
        }
        row.update(reference_pair_factors(str(pair)))
        row["doc_type"] = "bi" if "+" in str(doc_mix) else "mono"
        # doc regime relative to the query pair (L1/L2/L1+L2 docs)
        la, lb = (p.strip().upper() for p in str(pair).split("-")[:2])
        dm_langs = {
            tok for tok in re.split(r"[^A-Z]+", str(doc_mix).upper()) if tok
        }
        has_a, has_b = la in dm_langs, lb in dm_langs
        row["doc_regime"] = (
            "L1+L2 docs" if has_a and has_b
            else "L1 docs" if has_a
            else "L2 docs" if has_b
            else "other docs"
        )
        out.append(row)
    return out


def write_csv(path, rows: List[Dict]) -> None:
    import csv

    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if not rows:
        path.write_text("")
        return
    cols = list(rows[0].keys())
    for r in rows[1:]:  # union of keys, first-seen order (factor columns vary)
        for k in r:
            if k not in cols:
                cols.append(k)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=cols, restval="")
        w.writeheader()
        w.writerows(rows)


def collect_cli(args) -> None:
    rows = collect_results(args.results_root)
    out = pathlib.Path(args.out)
    if getattr(args, "reference_format", False):
        long_rows = reference_format_rows(rows)
        summary = compute_reference_summary(rows)
    else:
        # the long-form CSV drops the bulky per-query dicts
        long_rows = [
            {k: v for k, v in r.items() if k != "perquery"} for r in rows
        ]
        summary = compute_summary(rows)
    write_csv(out, long_rows)
    summary_path = out.with_name(out.stem + "_processed" + out.suffix)
    write_csv(summary_path, summary)
    print(
        f"collected {len(long_rows)} rows -> {out}; "
        f"{len(summary)} summary rows -> {summary_path}"
    )
