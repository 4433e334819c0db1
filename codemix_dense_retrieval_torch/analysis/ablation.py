"""Ablation-results collector.

Replaces `collect_ablation_results.py` (#12): parses the ablation result
-tree naming (`:470-535`) —

    <dataset>-<size>-bilingual-<a>-<b>[-<block>]-<N>bands-<model>
    <dataset>-<size>-mono-<doc>-<a>-<b>[-<block>]-<N>bands-<model>

with optional ``vector_mix`` subdirs and collision-suffixed ``-rN`` run
dirs (`run_ablation.sh resolve_outdir:351-377`) — keeping the ``block``
and ``model`` columns, then reuses the main collector's latest-timestamp
dedup and summary machinery.
"""

from __future__ import annotations

import json
import pathlib
import re
from typing import Dict, List, Optional

from codemix_dense_retrieval_torch.analysis.collect import (
    compute_summary,
    mix_ratio_from_runstem,
    write_csv,
)
from codemix_dense_retrieval_torch.io.naming import LANG_NAMES
from codemix_dense_retrieval_torch.io.naming import parse_eval_stem
from codemix_dense_retrieval_torch.utils.logging import get_logger

log = get_logger("ablation")

_BANDS_RE = re.compile(r"^(\d+)bands?$")
_RN_RE = re.compile(r"-r\d+$")
_LANG_TOKENS = set(LANG_NAMES) | set(LANG_NAMES.values())


def normalize_lang(tok: str) -> Optional[str]:
    tok = tok.lower()
    if tok in LANG_NAMES:  # already a code
        return tok
    for code, name in LANG_NAMES.items():
        if tok == name:
            return code
    return tok if len(tok) == 2 else None


def parse_ablation_dirname(name: str) -> Optional[Dict]:
    """Returns dict with dataset/docs_size/exp_type/block/doc_lang/q1/q2/
    model, or None. ``-rN`` collision suffixes are stripped."""
    name = _RN_RE.sub("", name)
    parts = name.split("-")
    if len(parts) < 4:
        return None
    band_idx = None
    for i, tok in enumerate(parts):
        if _BANDS_RE.match(tok):
            band_idx = i
            break
    if band_idx is None or band_idx <= 2:
        return None
    info: Dict = {
        "dataset": parts[0],
        "docs_size": parts[1],
        "num_bands": int(_BANDS_RE.match(parts[band_idx]).group(1)),
        "model": "-".join(parts[band_idx + 1:]) or None,
        "block": None,
        "doc_lang": None,
        "q1": None,
        "q2": None,
    }
    exp = parts[2:band_idx]
    if not exp:
        return None
    info["exp_tag"] = "-".join(exp)
    exp_type = exp[0].lower()
    info["exp_type"] = exp_type
    if exp_type == "bilingual":
        if len(exp) >= 3:
            info["q1"], info["q2"] = normalize_lang(exp[1]), normalize_lang(exp[2])
            if info["q1"] and info["q2"]:
                info["doc_lang"] = f"{info['q1']}-{info['q2']}"
        if len(exp) >= 4:
            info["block"] = exp[3]
    elif exp_type == "mono":
        if len(exp) >= 4:
            info["doc_lang"] = normalize_lang(exp[1])
            info["q1"], info["q2"] = normalize_lang(exp[2]), normalize_lang(exp[3])
        if len(exp) >= 5:
            info["block"] = exp[4]
    else:
        langs = [p for p in exp if p.lower() in _LANG_TOKENS]
        if len(langs) >= 2:
            info["q1"], info["q2"] = normalize_lang(langs[0]), normalize_lang(langs[1])
        if langs:
            info["doc_lang"] = normalize_lang(langs[0])
        info["block"] = exp[-1]
    return info


def collect_ablation_results(results_root) -> List[Dict]:
    root = pathlib.Path(results_root)
    latest: Dict = {}
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
        info = None
        for p in [pathlib.Path(parent)] + list(pathlib.Path(parent).parents):
            info = parse_ablation_dirname(p.name)
            if info:
                break
        if not info:
            continue
        mix = mix_ratio_from_runstem(runstem)
        if mix is None:
            continue
        mix_mode, ratio = mix
        if pathlib.Path(parent).name.startswith("vector"):
            mix_mode = "embed"
        try:
            metrics = json.loads(agg.read_text())
        except (OSError, json.JSONDecodeError) as e:
            log.warning("skipping unreadable %s: %s", agg, e)
            continue
        rows.append(
            {
                "experiment": pathlib.Path(parent).name,
                "dataset": info["dataset"],
                "docs_size": info["docs_size"],
                "exp_type": info["exp_type"],
                "block": info["block"],
                "doc_side": info["doc_lang"],
                "pair": (
                    f"{info['q1'].upper()}-{info['q2'].upper()}"
                    if info["q1"] and info["q2"] else None
                ),
                "model": info["model"],
                "split": split,
                "run": runstem,
                "mix_mode": mix_mode,
                "mix_ratio": ratio,
                "timestamp": ts,
                "ndcg10": metrics.get("nDCG@10"),
                "mrr10": metrics.get("RR@10"),
                "recall10": metrics.get("R@10"),
                "map": metrics.get("AP"),
            }
        )
    return rows


def compute_ablation_summary(rows: List[Dict]) -> List[Dict]:
    """Per (pair, doc, mix_mode, model, block) best-interior delta."""
    # reuse the main summary but keep block in the key by folding it into
    # the model column temporarily
    tagged = []
    for r in rows:
        r2 = dict(r)
        r2["model"] = f"{r.get('model')}|{r.get('block')}"
        tagged.append(r2)
    out = compute_summary(tagged)
    for row in out:
        model_block = str(row["model"]).split("|")
        row["model"] = model_block[0]
        row["block"] = model_block[1] if len(model_block) > 1 else None
    return out


# ---------------------------------------------------------------------------
# reference-format export (parity with the shipped ablation_results.csv /
# ablation_processed_results.csv — `collect_ablation_results.py:144-264,574-694`)
# ---------------------------------------------------------------------------

_RESULT_DIR_RE = re.compile(r"^(vector(?:_mix)?)(?:-r(\d+))?$", re.IGNORECASE)

REFERENCE_ABLATION_COLUMNS = [
    "dataset", "docs_size", "num_bands", "exp_tag", "exp_type", "block",
    "doc_lang", "query_lang_a", "query_lang_b", "pair", "doc_mix", "method",
    "mix_ratio", "ndcg10", "ndcg10_std", "ndcg10_stderr", "ndcg10_ci90_low",
    "ndcg10_ci90_high", "ndcg10_ci95_low", "ndcg10_ci95_high", "mrr10",
    "r10", "model", "result_kind", "result_variant", "experiment_dir",
    "source_file",
]

# agg.json metric key -> reference export column (values x100, 4dp)
_ABL_METRIC_COLS = {
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


def _ref_doc_mix(info: Dict, pair: str) -> str:
    """`human_doc_mix` (`collect_ablation_results.py:211-224`): bilingual
    experiments label by the pair ("AR + ZH docs"), mono by the doc code."""
    if info["exp_type"] == "bilingual" and pair:
        a, b = pair.split("-")[:2]
        return f"{a} + {b} docs"
    code = (info.get("doc_lang") or "").upper()
    return f"{code} docs" if code else "docs"


def reference_format_ablation_rows(
    results_root, result_dir_name: Optional[str] = "vector_mix"
) -> List[Dict]:
    """One row per latest vector-mix agg result, in the shipped
    ``ablation_results.csv`` vocabulary. The reference collector ships
    with ``RESULT_DIR_NAME = "vector_mix"`` — only dirs named exactly
    that are collected (word-mix runs and ``vector``/``-rN`` variant dirs
    are excluded); pass ``result_dir_name=None`` to accept every
    ``vector``/``vector_mix``/``-rN`` dir like its regex fallback."""
    root = pathlib.Path(results_root)
    latest: Dict = {}
    for agg in root.rglob("*-agg.json"):
        if result_dir_name is not None:
            if agg.parent.name.lower() != result_dir_name.lower():
                continue
            m = None
        else:
            m = _RESULT_DIR_RE.match(agg.parent.name)
            if not m:
                continue
        parsed = parse_eval_stem(agg.name[: -len("-agg.json")])
        if not parsed:
            continue
        runstem, split, ts = parsed
        key = (str(agg.parent), runstem, split)
        if m is None:
            kind, variant = agg.parent.name.lower(), ""
        else:
            kind, variant = m.group(1).lower(), f"r{m.group(2)}" if m.group(2) else ""
        if key not in latest or ts > latest[key][0]:
            latest[key] = (ts, agg, kind, variant)

    out: List[Dict] = []
    for (parent, runstem, split), (ts, agg, kind, variant) in latest.items():
        info = exp_dir = None
        for p in [pathlib.Path(parent)] + list(pathlib.Path(parent).parents):
            info = parse_ablation_dirname(p.name)
            if info:
                exp_dir = p
                break
        if not info:
            continue
        mix = mix_ratio_from_runstem(runstem)
        if mix is None:
            continue
        _, ratio = mix
        try:
            metrics = json.loads(agg.read_text())
        except (OSError, json.JSONDecodeError) as e:
            log.warning("skipping unreadable %s: %s", agg, e)
            continue
        pair = (
            f"{info['q1'].upper()}-{info['q2'].upper()}"
            if info["q1"] and info["q2"] else ""
        )
        # the reference reads the sibling agg CSV; point source_file there
        src = agg.with_name(agg.name[: -len(".json")] + ".csv")
        if not src.exists():
            src = agg
        row = {
            "dataset": info["dataset"],
            "docs_size": info["docs_size"],
            "num_bands": info["num_bands"],
            "exp_tag": info["exp_tag"],
            "exp_type": info["exp_type"],
            "block": info["block"],
            "doc_lang": info["doc_lang"],
            "query_lang_a": info["q1"],
            "query_lang_b": info["q2"],
            "pair": pair,
            "doc_mix": _ref_doc_mix(info, pair),
            "method": "embed",
            "mix_ratio": ratio,
            "model": info["model"],
            "result_kind": kind,
            "result_variant": variant,
            "experiment_dir": exp_dir.name,
            "source_file": str(src.relative_to(root)),
        }
        for key, col in _ABL_METRIC_COLS.items():
            v = metrics.get(key)
            row[col] = round(v * 100.0, 4) if v is not None else None
        if row["ndcg10"] is None and row["mrr10"] is None and row["r10"] is None:
            continue
        out.append(row)
    out.sort(key=lambda r: tuple(str(r.get(c)) for c in (
        "dataset", "docs_size", "exp_type", "block", "pair", "doc_mix",
        "method",
    )) + (float(r["mix_ratio"]),) + tuple(str(r.get(c)) for c in (
        "model", "experiment_dir", "source_file",
    )))
    return out


_REF_PROCESSED_GROUP = [
    "dataset", "docs_size", "num_bands", "exp_tag", "exp_type", "block",
    "doc_lang", "query_lang_a", "query_lang_b", "pair", "doc_mix", "method",
    "model", "result_kind", "result_variant",
]


def compute_reference_ablation_summary(ref_rows: List[Dict]) -> List[Dict]:
    """The shipped ``ablation_processed_results.csv``: per 15-column group,
    best endpoint (mix 0/100) vs best interior nDCG@10, delta, lambda*,
    plus the pair-factor columns (`collect_ablation_results.py:803-841`)."""
    from collections import defaultdict

    from codemix_dense_retrieval_torch.analysis.lang_factors import (
        reference_pair_factors,
    )

    groups: Dict[tuple, List[Dict]] = defaultdict(list)
    for r in ref_rows:
        groups[tuple(r.get(c) for c in _REF_PROCESSED_GROUP)].append(r)
    out: List[Dict] = []
    for key in sorted(groups, key=lambda k: tuple(str(x) for x in k)):
        grp = [g for g in groups[key] if g.get("ndcg10") is not None]
        row = dict(zip(_REF_PROCESSED_GROUP, key))
        endpoints = [g["ndcg10"] for g in grp if g["mix_ratio"] in (0.0, 100.0)]
        interior = [g for g in grp if 0.0 < g["mix_ratio"] < 100.0]
        best_endpoint = max(endpoints) if endpoints else float("nan")
        if interior:
            best = max(interior, key=lambda g: g["ndcg10"])
            best_mixed, lambda_star = best["ndcg10"], best["mix_ratio"]
            import math as _math

            delta = best_mixed - (
                best_endpoint if not _math.isnan(best_endpoint) else 0.0
            )
        else:
            best_mixed = lambda_star = float("nan")
            delta = 0.0
        row.update(
            best_endpoint_ndcg=best_endpoint, best_mixed_ndcg=best_mixed,
            delta_ndcg=delta, lambda_star_mid=lambda_star,
        )
        factors = reference_pair_factors(str(row["pair"]))
        # the reference ablation script looks distances up by EXACT pair
        # key (`PAIR_EXTRA_METRICS.get(normalize_pair(pair), {})`) — no
        # order-insensitive fallback, so e.g. DE-EN gets empty extras
        for dk in ("lang2vec_knn", "gram_bank", "script", "glot_tree"):
            factors[dk] = ""
        from codemix_dense_retrieval_torch.analysis.lang_factors import (
            PAIR_DISTANCES,
        )

        factors.update(PAIR_DISTANCES.get(str(row["pair"]).upper(), {}))
        row.update(factors)
        dm = str(row["doc_mix"])
        row["doc_type"] = "bi" if "+" in dm else "mono"
        pair_parts = [t.strip().upper() for t in str(row["pair"]).split("-") if t.strip()]
        la, lb = (pair_parts + ["", ""])[:2]  # empty/one-token pairs survive
        dm_langs = {t for t in re.split(r"[^A-Z]+", dm.upper()) if t}
        has_a = bool(la) and la in dm_langs
        has_b = bool(lb) and lb in dm_langs
        row["doc_regime"] = (
            "L1+L2 docs" if has_a and has_b
            else "L1 docs" if has_a
            else "L2 docs" if has_b
            else "other docs"
        )
        out.append(row)
    return out


def collect_ablation_cli(results_root, out, *, reference_format: bool = False) -> None:
    out = pathlib.Path(out)
    if reference_format:
        # emit the shipped ablation_results.csv / _processed schema
        # (proven byte-equal on the reference's real ablation2 tree,
        # tests/test_reference_ablation_parity.py)
        rows = reference_format_ablation_rows(results_root)
        summary = compute_reference_ablation_summary(rows)
    else:
        rows = collect_ablation_results(results_root)
        summary = compute_ablation_summary(rows)
    write_csv(out, rows)
    write_csv(out.with_name(out.stem + "_processed" + out.suffix), summary)
