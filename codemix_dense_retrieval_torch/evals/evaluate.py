"""Evaluate a TREC run against qrels, with the metric math of
``evals.metrics``.

Outputs under ``--outdir``:

- ``<runstem>_<split>_<ts>-agg.csv`` / ``-agg.json``  (metrics x100, nDCG CI stats)
- ``<runstem>_<split>_<ts>-perquery.csv``             (with ``--perquery``)
- ``<runstem>_<split>_<ts>-diagnostic.txt``           (num_queries/... counts)

The ``-agg.json`` schema and numbers equal the JAX package's for the same
run and qrels. Programmatic entry: :func:`evaluate_run`.
"""

from __future__ import annotations

import argparse
import collections
import csv
import datetime
import json
import math
import os
import pathlib
import re
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from codemix_dense_retrieval_torch.evals import metrics as M
from codemix_dense_retrieval_torch.io.tsv import read_qrels, write_qrels_tsv

_DEFAULT_METRICS = """
 nDCG@1 nDCG@3 nDCG@5 nDCG@10 nDCG@100
 MRR@1 MRR@3 MRR@5 MRR@10 MRR@100
 P@1  P@3  P@5  P@10  P@100
 Recall@1 Recall@3 Recall@5 Recall@10 Recall@100
 AP MAP
""".split()

_PERCENT_SCALE = 100.0


def load_run_grouped(path: pathlib.Path) -> M.Run:
    """Load a TREC run as {qid: [(docid, score), ...]}."""
    run: M.Run = collections.defaultdict(list)
    with path.open("r", encoding="utf-8") as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            qid, _, docid, _, score, _ = line.split()
            run[qid].append((docid, float(score)))
    return dict(run)


def filter_docids(qrels: M.Qrels, allowed: set) -> M.Qrels:
    """Drop qrels rows whose docid was never indexed (subset evaluation)."""
    out: M.Qrels = {}
    for qid, judged in qrels.items():
        kept = {d: r for d, r in judged.items() if d in allowed}
        if kept:
            out[qid] = kept
    return out


def filter_qids(qrels: M.Qrels, run: M.Run, allowed: set) -> Tuple[M.Qrels, M.Run]:
    """Keep only common-band qids in both qrels and run."""
    q2 = {q: j for q, j in qrels.items() if q in allowed}
    r2 = {q: rows for q, rows in run.items() if q in allowed}
    return q2, r2


def evaluate_run(
    run: M.Run,
    qrels: M.Qrels,
    metric_tokens: Optional[Sequence[str]] = None,
    perquery: bool = False,
):
    """Compute the aggregate dict (x100, with nDCG CI stats), per-query rows,
    and diagnostics. Returns (ordered_agg, perquery_rows, diag)."""
    measures = M.parse_measures(metric_tokens or _DEFAULT_METRICS)
    metric_names = [str(m) for m in measures]

    ndcg_values: Dict[str, List[float]] = collections.defaultdict(list)
    perquery_rows: List[Tuple[str, str, float]] = []
    sums = {name: 0.0 for name in metric_names}
    nq = 0
    for qid, judged in qrels.items():
        vals = M._per_query(measures, judged, run.get(qid, []))
        nq += 1
        for name in metric_names:
            scaled = vals[name] * _PERCENT_SCALE
            sums[name] += vals[name]
            if name.lower().startswith("ndcg"):
                ndcg_values[name].append(scaled)
            if perquery:
                perquery_rows.append((qid, name, scaled))

    ordered: "collections.OrderedDict[str, float]" = collections.OrderedDict()
    for name in metric_names:
        mean = (sums[name] / nq) * _PERCENT_SCALE if nq else float("nan")
        ordered[name] = mean
        if name.lower().startswith("ndcg"):
            stats = M.ndcg_statistics(ndcg_values.get(name, []), mean)
            if stats:
                for suffix in ("std", "stderr", "ci90_low", "ci90_high", "ci95_low", "ci95_high"):
                    ordered[f"{name}_{suffix}"] = stats[suffix]

    qrels_docs = {(q, d) for q, judged in qrels.items() for d in judged}
    retrieved = {(q, d) for q, rows in run.items() for d, _ in rows}
    overlap = qrels_docs & retrieved
    diag = {
        "num_queries": len(qrels),
        "num_retrieved": len(retrieved),
        "num_relevant": len(qrels_docs),
        "num_overlap": len(overlap),
        "pct_unjudged": (1 - len(overlap) / max(1, len(retrieved))) * _PERCENT_SCALE,
    }
    return ordered, perquery_rows, diag


def _csv_column(values: List[object]) -> List[str]:
    """One column's fields as pandas ``to_csv`` writes them (``None`` =
    missing cell): a complete column of ints as ints, otherwise floats by
    ``repr`` with NaN and missing cells empty."""
    if values and all(isinstance(v, int) and not isinstance(v, bool) for v in values):
        return [str(v) for v in values]
    out = []
    for v in values:
        f = float("nan") if v is None else float(v)
        out.append("" if math.isnan(f) else repr(f))
    return out


def _write_csv(path: pathlib.Path, header: List[str], columns: List[List[str]]) -> None:
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(header)
        w.writerows(zip(*columns))


def write_artifacts(
    ordered: Dict[str, float],
    perquery_rows: List[Tuple[str, str, float]],
    diag: Dict[str, float],
    run_path: pathlib.Path,
    split: str,
    outdir: pathlib.Path,
    metric_names: Optional[List[str]] = None,
    timestamp: Optional[str] = None,
) -> pathlib.Path:
    """Write the -agg.csv/-agg.json/-perquery.csv/-diagnostic.txt quartet,
    byte for byte as the JAX package's pandas ``to_csv`` does (plain csv, no
    pandas); returns the artifact base path."""
    ts = timestamp or datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    stem = run_path.stem
    base = f"{stem}_{split}_{ts}"
    outdir.mkdir(parents=True, exist_ok=True)

    _write_csv(outdir / f"{base}-agg.csv", list(ordered), [_csv_column([v]) for v in ordered.values()])
    with open(outdir / f"{base}-agg.json", "w") as fh:
        json.dump(ordered, fh, indent=2)
    if perquery_rows:
        names = metric_names or sorted({m for _, m, _ in perquery_rows})
        table: Dict[str, Dict[str, float]] = {}
        for qid, name, val in perquery_rows:
            table.setdefault(qid, {})[name] = val
        qids = sorted(table)
        _write_csv(outdir / f"{base}-perquery.csv", ["qid", *names],
                   [qids] + [_csv_column([table[q].get(n) for q in qids]) for n in names])
    with open(outdir / f"{base}-diagnostic.txt", "w") as fh:
        for k, v in diag.items():
            print(f"{k}: {v}", file=fh)
    return outdir / base


def _resolve_qrels_cache_path(cache_path: str, repo: str, config: str, split: str) -> pathlib.Path:
    path = pathlib.Path(cache_path)
    safe = re.sub(r"[^A-Za-z0-9_.-]+", "_", f"{repo}-{config}-{split}")
    if path.exists() and path.is_dir():
        return path / f"{safe}.tsv"
    if path.suffix:
        return path
    return path / f"{safe}.tsv"


def _load_qrels_hf(repo, config, split, id_field, doc_field, rel_field, trust_remote, streaming):
    from datasets import load_dataset

    ds = load_dataset(repo, config, split=split, streaming=streaming, trust_remote_code=trust_remote)
    qrels: M.Qrels = {}
    for r in ds:
        qrels.setdefault(str(r[id_field]), {})[str(r[doc_field])] = int(r[rel_field])
    return qrels


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--run", required=True)
    ap.add_argument("--split", default="dev")
    ap.add_argument("--outdir", default="results")
    ap.add_argument("--qrels")
    ap.add_argument("--qrels_repo")
    ap.add_argument("--qrels_config", default="default")
    ap.add_argument("--qrels_split", default="validation")
    ap.add_argument("--id_field", default="query-id")
    ap.add_argument("--doc_field", default="corpus-id")
    ap.add_argument("--rel_field", default="score")
    ap.add_argument("--trust_remote", action="store_true")
    ap.add_argument("--qrels_cache")
    ap.add_argument("--qrels_streaming", action="store_true")
    ap.add_argument("--metrics", nargs="+")
    ap.add_argument("--perquery", action="store_true")
    ap.add_argument("--filter_docids")
    ap.add_argument("--filter_qids")
    args = ap.parse_args(argv)

    if args.qrels_repo:
        cache_path = None
        if args.qrels_cache and not args.qrels_streaming:
            cache_path = _resolve_qrels_cache_path(
                args.qrels_cache, args.qrels_repo, args.qrels_config, args.qrels_split
            )
        if cache_path is not None and cache_path.exists():
            qrels = read_qrels(cache_path)
        else:
            qrels = _load_qrels_hf(
                args.qrels_repo, args.qrels_config, args.qrels_split,
                args.id_field, args.doc_field, args.rel_field,
                args.trust_remote, streaming=args.qrels_streaming,
            )
            if cache_path is not None:
                write_qrels_tsv(cache_path, qrels)
    else:
        if args.qrels:
            qrels_path = pathlib.Path(args.qrels)
        else:
            base = os.environ.get(
                "DATA_ROOT", str(pathlib.Path(__file__).resolve().parents[2] / "data")
            )
            droot = pathlib.Path(base) / args.dataset
            qrels_path = next((droot / "qrels").glob(f"{args.split}.*"), None)
            if not qrels_path:
                sys.exit(f"[ERROR] No qrels for split {args.split} under {droot/'qrels'}")
        qrels = read_qrels(qrels_path)

    run_path = pathlib.Path(args.run)
    run = load_run_grouped(run_path)

    if args.filter_docids:
        allowed = set(pathlib.Path(args.filter_docids).read_text().splitlines())
        qrels = filter_docids(qrels, allowed)
        print(f"[i] Filtered qrels: {len(allowed)} docs kept.")
    if not qrels:
        sys.exit(
            "[ERROR] After filtering, no qrels remain; metrics would all be zero. "
            "Check --filter_docids or your corpus subset."
        )
    if args.filter_qids:
        lines = pathlib.Path(args.filter_qids).read_text(encoding="utf-8").splitlines()
        allowed = {line.strip().split()[0] for line in lines if line.strip()}
        qrels, run = filter_qids(qrels, run, allowed)
        print(f"[i] Filtered to {len(qrels)} queries by --filter_qids from {args.filter_qids}")

    metric_tokens = args.metrics if args.metrics else _DEFAULT_METRICS
    ordered, perquery_rows, diag = evaluate_run(run, qrels, metric_tokens, args.perquery)

    for k, v in ordered.items():
        print(f"{k}: {v:.4f}")
    print()

    metric_names = [str(m) for m in M.parse_measures(metric_tokens)]
    base = write_artifacts(
        ordered, perquery_rows, diag, run_path, args.split, pathlib.Path(args.outdir), metric_names
    )
    print(f"[i] Wrote {base}-agg.json")


if __name__ == "__main__":
    main()
