"""Sweep-plan builders — the reference's bash job matrices as data.

Replicates the experiment matrices of `run_all_vector_pairs.sh:74-183`
(35 bilingual pairs + 70 mono jobs = for every bilingual pair, one
doc-language-A and one doc-language-B mono job) and the six-job EN-ZH
reproduction of `reproduce_en_zh.sh:127-341`, emitting Scheduler plans
(JSON) whose jobs run the framework's own CLI with resume-by-artifact
expected-file patterns and per-band eval steps.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

from codemix_dense_retrieval_torch.config import DEFAULT_ALPHAS, format_alpha
from codemix_dense_retrieval_torch.io.naming import LANG_NAMES, encoder_tag

# `run_all_vector_pairs.sh:74-110`
BILINGUAL_PAIRS_DEFAULT: Tuple[Tuple[str, str], ...] = (
    ("en", "fr"), ("en", "it"), ("en", "pt"), ("en", "nl"),
    ("es", "fr"), ("es", "it"), ("fr", "pt"), ("it", "pt"),
    ("de", "fr"), ("de", "it"), ("nl", "fr"), ("nl", "it"),
    ("nl", "es"), ("ja", "hi"), ("ja", "ru"), ("ar", "zh"),
    ("hi", "zh"), ("es", "pt"), ("de", "nl"), ("en", "de"),
    ("en", "es"), ("es", "de"), ("en", "id"), ("id", "vi"),
    ("en", "vi"), ("en", "ru"), ("en", "hi"), ("en", "ar"),
    ("en", "zh"), ("id", "zh"), ("en", "ja"), ("hi", "ar"),
    ("fr", "it"), ("zh", "ja"), ("zh", "ru"),
)


def mono_jobs_for_pairs(
    pairs: Sequence[Tuple[str, str]] = BILINGUAL_PAIRS_DEFAULT,
) -> List[Tuple[str, str, str]]:
    """(docLang, queryLangA, queryLangB) — two mono jobs per pair
    (`run_all_vector_pairs.sh:112-183` pattern: doc side = each of the two
    query languages in turn)."""
    jobs: List[Tuple[str, str, str]] = []
    for a, b in pairs:
        jobs.append((a, a, b))
        jobs.append((b, a, b))
    return jobs


def vector_mix_job(
    *,
    doc_side: str,  # language code or "bilingual"
    lang_a: str,
    lang_b: str,
    index_root: str,
    query_tsv_a: str,
    query_tsv_b: str,
    result_root: str,
    encoder: str = "BAAI/bge-m3",
    checkpoint: Optional[str] = None,
    alphas: Sequence[float] = DEFAULT_ALPHAS,
    dataset: str = "mmarco",
    size: int = 8_841_823,
    qrels: Optional[str] = None,
    k: Optional[int] = None,
    query_cache_root: Optional[str] = None,
    approx: Optional[str] = None,  # "fast" | "guaranteed" (sketch tier)
    extra_runner_args: Sequence[str] = (),
) -> Dict:
    """One vector-mix job dict for the Scheduler plan.

    ``extra_runner_args`` are appended verbatim to the runner argv (e.g.
    ``--smoke_dim 32`` for synthetic round-trips, ``--enc_batch``
    overrides) — the analog of the bash schedulers' per-model env
    overrides (`run_encode_index_ablation.sh:118-132`)."""
    tag = encoder_tag(encoder)
    bilingual = doc_side == "bilingual"
    if bilingual:
        side_name = f"bilingual-{lang_a}-{lang_b}"
        exp = f"{dataset}-{size}-{side_name}-5bands-{tag}"
    else:
        side_name = LANG_NAMES.get(doc_side, doc_side)
        exp = f"{dataset}-{size}-{side_name}-{lang_a}-{lang_b}-5bands-{tag}"
    outdir = str(pathlib.Path(result_root) / exp / "vector_mix")
    name = f"vecmix-{side_name}-{lang_a}-{lang_b}-{tag}"
    alpha_labels = [format_alpha(a) for a in alphas]
    if bilingual:
        argv = [
            "run-bilingual-mix",
            "--index", str(pathlib.Path(index_root) / lang_a),
            str(pathlib.Path(index_root) / lang_b),
            "--lang_tags", lang_a, lang_b,
            "--query_tsv", f"{lang_a}={query_tsv_a}", f"{lang_b}={query_tsv_b}",
            "--cm_alphas", *[str(a) for a in alphas],
            "--outdir", outdir,
            "--encoder", encoder,
            "--k", str(k or 500),
        ]
        run_suffix = "_base"
    else:
        argv = [
            "run-mix",
            "--index", str(pathlib.Path(index_root) / doc_side),
            "--query_tsv", f"{lang_a}={query_tsv_a}", f"{lang_b}={query_tsv_b}",
            "--cm_alphas", *[str(a) for a in alphas],
            "--outdir", outdir,
            "--encoder", encoder,
            "--k", str(k or 100),
        ]
        run_suffix = ""
    if approx:
        argv += ["--approx", approx]
    if checkpoint:
        argv += ["--checkpoint", checkpoint]
    if query_cache_root and not bilingual:
        argv += ["--query_cache", str(pathlib.Path(query_cache_root) / f"{lang_a}-{lang_b}")]
    argv += list(extra_runner_args)

    eval_after: List[List[str]] = []
    expected = [f"cm-alpha-{lab}{run_suffix}.trec" for lab in alpha_labels]
    if qrels:
        for lab in alpha_labels:
            eval_after.append([
                "evaluate",
                "--dataset", dataset,
                "--run", str(pathlib.Path(outdir) / f"cm-alpha-{lab}{run_suffix}.trec"),
                "--qrels", qrels,
                "--outdir", outdir,
            ])
        expected += [f"cm-alpha-{lab}{run_suffix}_dev_*-agg.json" for lab in alpha_labels]
    return {
        "name": name,
        "argv": argv,
        "outdir": outdir,
        "expected": expected,
        "eval_after": eval_after,
    }


def rerank_job(
    *,
    doc_langs: Sequence[str],  # one = mono two-stage, two = bilingual hub
    queries: str,  # band dir or TSV path
    index_root: str,
    result_root: str,
    encoder: str = "BAAI/bge-m3",
    checkpoint: Optional[str] = None,
    dataset: str = "mmarco",
    size: int = 8_841_823,
    qrels: Optional[str] = None,
    k: int = 100,
    k_dense: int = 0,
    query_cache_root: Optional[str] = None,
    band_names: Sequence[str] = ("cm0", "cm20-40", "cm40-60", "cm60-80", "cm100"),
) -> Dict:
    """One two-stage (dense recall + MaxSim rerank) job dict.

    Beyond-parity job type: requires indexes built with
    ``encode-corpus --tokens_per_doc``. Expected artifacts follow the
    word-mix band naming; bilingual jobs expect the collapsed
    ``*_base.trec`` runs."""
    tag = encoder_tag(encoder)
    bilingual = len(doc_langs) > 1
    side = (
        f"bilingual-{'-'.join(doc_langs)}" if bilingual
        else LANG_NAMES.get(doc_langs[0], doc_langs[0])
    )
    exp = f"{dataset}-{size}-{side}-5bands-{tag}"
    outdir = str(pathlib.Path(result_root) / exp / "rerank")
    argv = [
        "run-rerank",
        "--index", *[str(pathlib.Path(index_root) / l) for l in doc_langs],
        "--queries", queries,
        "--outdir", outdir,
        "--encoder", encoder,
        "--k", str(k),
    ]
    if k_dense:
        argv += ["--k_dense", str(k_dense)]
    if checkpoint:
        argv += ["--checkpoint", checkpoint]
    if query_cache_root and not bilingual:
        argv += ["--query_cache", str(pathlib.Path(query_cache_root) / side)]
    suffix = "_base" if bilingual else ""
    expected = [f"{b}{suffix}.trec" for b in band_names]
    eval_after: List[List[str]] = []
    if qrels:
        for b in band_names:
            eval_after.append([
                "evaluate",
                "--dataset", dataset,
                "--run", str(pathlib.Path(outdir) / f"{b}{suffix}.trec"),
                "--qrels", qrels,
                "--outdir", outdir,
            ])
        expected += [f"{b}{suffix}_dev_*-agg.json" for b in band_names]
    return {
        "name": f"rerank-{side}-{tag}",
        "argv": argv,
        "outdir": outdir,
        "expected": expected,
        "eval_after": eval_after,
    }


def build_all_pairs_plan(
    *,
    index_root: str,
    query_tsv_root: str,  # expects queries.<lang>.tsv files
    result_root: str,
    encoder: str = "BAAI/bge-m3",
    checkpoint: Optional[str] = None,
    pairs: Sequence[Tuple[str, str]] = BILINGUAL_PAIRS_DEFAULT,
    qrels: Optional[str] = None,
    **kw,
) -> Dict:
    """The full sweep: per pair one bilingual job + two mono jobs
    (105 jobs for the default 35 pairs — the reference's full matrix)."""
    q = lambda lang: str(pathlib.Path(query_tsv_root) / f"queries.{lang}.tsv")
    jobs: List[Dict] = []
    for a, b in pairs:
        jobs.append(
            vector_mix_job(
                doc_side="bilingual", lang_a=a, lang_b=b, index_root=index_root,
                query_tsv_a=q(a), query_tsv_b=q(b), result_root=result_root,
                encoder=encoder, checkpoint=checkpoint, qrels=qrels, **kw,
            )
        )
    for doc, a, b in mono_jobs_for_pairs(pairs):
        jobs.append(
            vector_mix_job(
                doc_side=doc, lang_a=a, lang_b=b, index_root=index_root,
                query_tsv_a=q(a), query_tsv_b=q(b), result_root=result_root,
                encoder=encoder, checkpoint=checkpoint, qrels=qrels, **kw,
            )
        )
    return {"jobs": jobs}


def build_en_zh_repro_plan(
    *,
    index_root: str,
    query_tsv_en: str,
    query_tsv_zh: str,
    band_dir: Optional[str],
    result_root: str,
    encoder: str = "BAAI/bge-m3",
    checkpoint: Optional[str] = None,
    qrels: Optional[str] = None,
    size: int = 100_000,
    k: Optional[int] = None,
    extra_runner_args: Sequence[str] = (),
) -> Dict:
    """The six-job EN-ZH reproduction (`reproduce_en_zh.sh:127-341`):
    mono-EN/ZH x word/vector mix + bilingual word/vector mix.

    With ``qrels``, word-mix jobs get per-band eval steps (the band set
    is read from ``band_dir`` at plan-build time — the analog of
    `reproduce_en_zh.sh`'s per-band eval loop)."""
    tag = encoder_tag(encoder)
    jobs: List[Dict] = []
    for doc in ("en", "zh"):
        jobs.append(
            vector_mix_job(
                doc_side=doc, lang_a="en", lang_b="zh", index_root=index_root,
                query_tsv_a=query_tsv_en, query_tsv_b=query_tsv_zh,
                result_root=result_root, encoder=encoder, checkpoint=checkpoint,
                qrels=qrels, dataset="mmarco", size=size, k=k,
                extra_runner_args=extra_runner_args,
            )
        )
    jobs.append(
        vector_mix_job(
            doc_side="bilingual", lang_a="en", lang_b="zh", index_root=index_root,
            query_tsv_a=query_tsv_en, query_tsv_b=query_tsv_zh,
            result_root=result_root, encoder=encoder, checkpoint=checkpoint,
            qrels=qrels, dataset="mmarco", size=size, k=k,
            extra_runner_args=extra_runner_args,
        )
    )
    if band_dir:
        bands = sorted(
            f.stem.replace("queries-", "")
            for f in pathlib.Path(band_dir).glob("queries-cm*.tsv")
        )

        def _word_job(name, argv, outdir, suffix):
            expected = (
                [f"{b}{suffix}.trec" for b in bands]
                if bands else [f"cm*{suffix}.trec"]
            )
            eval_after: List[List[str]] = []
            if qrels and bands:
                for b in bands:
                    eval_after.append([
                        "evaluate", "--dataset", "mmarco",
                        "--run", str(pathlib.Path(outdir) / f"{b}{suffix}.trec"),
                        "--qrels", qrels, "--outdir", outdir,
                    ])
                expected += [f"{b}{suffix}_dev_*-agg.json" for b in bands]
            return {
                "name": name, "argv": argv, "outdir": outdir,
                "expected": expected, "eval_after": eval_after,
            }

        for doc in ("en", "zh"):
            side = LANG_NAMES[doc]
            exp = f"mmarco-{size}-{side}-en-zh-5bands-{tag}"
            outdir = str(pathlib.Path(result_root) / exp)
            argv = [
                "run-mono",
                "--index", str(pathlib.Path(index_root) / doc),
                "--queries", band_dir,
                "--outdir", outdir,
                "--encoder", encoder,
            ]
            if k:
                argv += ["--k", str(k)]
            if checkpoint:
                argv += ["--checkpoint", checkpoint]
            argv += list(extra_runner_args)
            jobs.append(_word_job(f"wordmix-{side}-en-zh-{tag}", argv, outdir, ""))
        exp = f"mmarco-{size}-bilingual-en-zh-5bands-{tag}"
        outdir = str(pathlib.Path(result_root) / exp)
        argv = [
            "run-bilingual",
            "--index", str(pathlib.Path(index_root) / "en"), str(pathlib.Path(index_root) / "zh"),
            "--lang_tags", "en", "zh",
            "--queries", band_dir,
            "--outdir", outdir,
            "--encoder", encoder,
        ]
        if k:
            argv += ["--k", str(k)]
        if checkpoint:
            argv += ["--checkpoint", checkpoint]
        argv += list(extra_runner_args)
        jobs.append(
            _word_job(f"wordmix-bilingual-en-zh-{tag}", argv, outdir, "_base")
        )
    return {"jobs": jobs}


# ------------------------------------------------------------------------
# Ablation matrix (`run_ablation.sh:98-156`)
# ------------------------------------------------------------------------

ABLATION_MODELS: Dict[str, str] = {
    "me5-large-instruct": "intfloat/multilingual-e5-large-instruct",
    "gte-multilingual-base": "Alibaba-NLP/gte-multilingual-base",
    "jina-embedding-v3": "jinaai/jina-embeddings-v3",
    "qwen3-embedding-0.6B": "Qwen/Qwen3-Embedding-0.6B",
    "qwen3-embedding-4B": "Qwen/Qwen3-Embedding-4B",
    "qwen3-embedding-8B": "Qwen/Qwen3-Embedding-8B",
}
CORE_MODELS = (
    "me5-large-instruct", "gte-multilingual-base",
    "jina-embedding-v3", "qwen3-embedding-0.6B",
)
SIZE_MODELS = ("qwen3-embedding-0.6B", "qwen3-embedding-4B", "qwen3-embedding-8B")

COMPOSITION_PAIRS = (("en", "ar"), ("en", "zh"), ("de", "nl"), ("en", "de"),
                     ("ar", "zh"), ("zh", "ru"))
HUB_MONO_JOBS = (("zh", "id", "zh"), ("de", "de", "en"))
SCRIPT_MONO_JOBS = (("ru", "en", "ru"),)
HIGH_SIGNAL_MONO_JOBS = (
    ("ar", "en", "ar"), ("zh", "en", "zh"), ("de", "de", "nl"), ("zh", "id", "zh"),
    ("en", "en", "zh"), ("de", "de", "en"), ("ar", "ar", "zh"), ("zh", "ar", "zh"),
    ("zh", "zh", "ru"), ("ru", "zh", "ru"), ("en", "en", "ar"), ("en", "en", "de"),
    ("de", "en", "de"),
)
SIZE_BILINGUAL_PAIRS = (("en", "zh"), ("de", "nl"), ("ar", "zh"), ("zh", "ru"),
                        ("en", "de"))


def build_ablation_plan(
    *,
    index_root_by_model: Dict[str, str],
    query_tsv_root: str,
    result_root: str,
    checkpoints: Optional[Dict[str, str]] = None,
    qrels: Optional[str] = None,
    size: int = 100_000,
) -> Dict:
    """The encoder x block ablation matrix (`run_ablation.sh`): core models
    run composition/hub/script blocks; size models run the size block.
    Jobs are deduped on (model, side, pair). Per-model index roots mirror
    the reference's per-encoder index trees."""
    checkpoints = checkpoints or {}
    q = lambda lang: str(pathlib.Path(query_tsv_root) / f"queries.{lang}.tsv")
    jobs: List[Dict] = []
    seen = set()

    def add(model_tag: str, doc_side: str, a: str, b: str, block: str):
        key = (model_tag, doc_side, a, b)
        if key in seen:
            return
        seen.add(key)
        encoder = ABLATION_MODELS[model_tag]
        job = vector_mix_job(
            doc_side=doc_side, lang_a=a, lang_b=b,
            index_root=index_root_by_model[model_tag],
            query_tsv_a=q(a), query_tsv_b=q(b),
            result_root=str(pathlib.Path(result_root) / "ablation2"),
            encoder=encoder, checkpoint=checkpoints.get(model_tag),
            qrels=qrels, dataset="mmarco", size=size,
        )
        job["name"] = f"abl-{block}-{job['name']}"
        jobs.append(job)

    for model in CORE_MODELS:
        for a, b in COMPOSITION_PAIRS:
            add(model, "bilingual", a, b, "composition")
        for doc, a, b in HUB_MONO_JOBS + HIGH_SIGNAL_MONO_JOBS:
            add(model, doc, a, b, "hub")
        for doc, a, b in SCRIPT_MONO_JOBS:
            add(model, doc, a, b, "script")
    for model in SIZE_MODELS:
        for a, b in SIZE_BILINGUAL_PAIRS:
            add(model, "bilingual", a, b, "size")
    return {"jobs": jobs}


# Per-model encode batch defaults (the reference tunes these per encoder,
# `run_encode_index_ablation.sh:56-106`), overridable via env vars of the
# form ENC_BATCH_<TAG> (reference `get_override`, `:118-132`).
MODEL_ENC_BATCH: Dict[str, int] = {
    "bge-m3": 256,
    "me5-large-instruct": 256,
    "gte-multilingual-base": 512,
    "jina-embedding-v3": 256,
    "qwen3-embedding-0.6B": 256,
    "qwen3-embedding-4B": 64,
    "qwen3-embedding-8B": 32,
}


def get_override(prefix: str, tag: str, default):
    """Env override ``<PREFIX>_<TAG>`` with non-alnum chars mapped to ``_``
    and upper-cased (the reference's bash get_override convention)."""
    import os
    import re

    key = f"{prefix}_{re.sub(r'[^A-Za-z0-9]+', '_', tag)}".upper()
    raw = os.environ.get(key)
    if raw is None:
        return default
    try:
        return type(default)(raw)
    except (TypeError, ValueError):
        return raw


def enc_batch_for(model_tag: str, default: int = 256) -> int:
    return get_override("ENC_BATCH", model_tag, MODEL_ENC_BATCH.get(model_tag, default))


def write_plan(plan: Dict, path) -> pathlib.Path:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(plan, indent=2))
    return path
