"""A results tree made by the port on the CPU, for the collector, paper-value
and plot parity tests: seeded TREC runs written by the port's TREC writer
and evaluated by the port's ``evaluate`` (agg JSON + per-query CSVs), laid
out in the directories the port's plan builders name: vector-mix sweeps
over mono and bilingual doc sides, word-mix band runs, an approx-tier meta
and an ``ablation2`` subtree."""

import pathlib

import numpy as np

from codemix_dense_retrieval_torch.config import DEFAULT_ALPHAS, format_alpha
from codemix_dense_retrieval_torch.evals.evaluate import main as port_evaluate
from codemix_dense_retrieval_torch.io.trec import write_run
from codemix_dense_retrieval_torch.orchestrate import plans

PAIRS = (("en", "zh"), ("en", "ar"), ("ar", "zh"), ("hi", "zh"), ("de", "nl"), ("en", "de"))
N_QUERIES, N_DOCS, DEPTH = 24, 120, 12
BANDS = ("cm0", "cm20-40", "cm40-60", "cm60-80", "cm100")


def _qrels(path: pathlib.Path) -> None:
    lines = []
    for i in range(N_QUERIES):
        lines.append(f"q{i}\td{(3 * i) % N_DOCS}\t2\n")
        lines.append(f"q{i}\td{(3 * i + 1) % N_DOCS}\t1\n")
    path.write_text("".join(lines))


def _run_and_eval(outdir: pathlib.Path, stem: str, quality: float, rng, qrels: pathlib.Path,
                  perquery: bool = True) -> None:
    """One run whose relevant documents score ``quality`` above noise, then
    the port's evaluate over it (with its per-query CSV when ``perquery``)."""
    qids, docids, scores = [], [], []
    for i in range(N_QUERIES):
        rel = [(3 * i) % N_DOCS, (3 * i + 1) % N_DOCS]
        others = [d for d in rng.choice(N_DOCS, DEPTH, replace=False) if d not in rel][: DEPTH - 2]
        ids = rel + others
        s = np.concatenate([quality + 0.8 * rng.standard_normal(2), rng.standard_normal(len(others))])
        order = np.argsort(-s, kind="stable")
        qids.append(f"q{i}")
        docids.append([f"d{ids[j]}" for j in order])
        scores.append(s[order])
    run = outdir / f"{stem}.trec"
    write_run(run, qids, docids, np.asarray(scores, np.float32))
    port_evaluate(["--dataset", "mmarco", "--run", str(run), "--qrels", str(qrels), "--outdir", str(outdir),
                   *(["--perquery"] if perquery else [])])


def _sweep(job: dict, rng, qrels: pathlib.Path, suffix: str) -> None:
    a, b, c = rng.uniform(0.2, 1.5), rng.uniform(-1.0, 1.0), rng.uniform(-1.0, 3.0)
    outdir = pathlib.Path(job["outdir"])
    for alpha in DEFAULT_ALPHAS:
        quality = a + b * alpha + c * alpha * (1 - alpha)
        _run_and_eval(outdir, f"cm-alpha-{format_alpha(alpha)}{suffix}", quality, rng, qrels)


def build_results_tree(root: pathlib.Path, seed: int = 7) -> pathlib.Path:
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    qrels = root / "qrels.tsv"
    _qrels(qrels)
    results = root / "results"
    common = dict(index_root="ix", result_root=str(results), size=1000)
    for qa, qb in PAIRS:
        for side in (qa, qb, "bilingual"):
            job = plans.vector_mix_job(doc_side=side, lang_a=qa, lang_b=qb, query_tsv_a="a", query_tsv_b="b",
                                       **common)
            _sweep(job, rng, qrels, "_base" if side == "bilingual" else "")
    # word-mix bands beside the vector-mix sweeps (the run-mono layout)
    for qa, qb in PAIRS[:2]:
        outdir = pathlib.Path(plans.vector_mix_job(doc_side=qb, lang_a=qa, lang_b=qb, query_tsv_a="a",
                                                   query_tsv_b="b", **common)["outdir"]).parent
        for j, band in enumerate(BANDS):
            _run_and_eval(outdir, band, 0.6 + 0.2 * j, rng, qrels, perquery=False)
    # an approx-tier audit trail on one run
    meta = results / "mmarco-1000-chinese-en-zh-5bands-bge-m3" / "vector_mix" / "cm-alpha-0.5_meta.json"
    meta.write_text('{"certified_frac": 0.9375, "approx": "guaranteed"}')
    # the ablation subtree (block-tagged job names, per-model encoders)
    abl = plans.build_ablation_plan(
        index_root_by_model={tag: "ix" for tag in plans.ABLATION_MODELS}, query_tsv_root="q",
        result_root=str(results), size=1000,
    )
    for job in abl["jobs"][::9]:
        _sweep(job, rng, qrels, "_base" if "bilingual" in job["outdir"] else "")
    return results
