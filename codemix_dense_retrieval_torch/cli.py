"""Command-line interface: ``python -m codemix_dense_retrieval_torch <command>``.

========================  ==============================================
command                   what it does
========================  ==============================================
encode-corpus             encode per-language corpora into shard stores
                          (bf16 by default; ``--storage_dtype int8``
                          writes int8 rows + ``scales.bin``;
                          ``--tokens_per_doc T`` adds a token store)
run-mono                  word-mix band search over one index
run-mix                   vector-mix alpha sweep over one index
                          (``--fused [--qrels]``: the sweep and its
                          metrics on the device)
run-bilingual             word-mix band search over a bilingual hub
                          (raw run + max-collapsed run per set)
run-bilingual-mix         vector-mix alpha sweep over a bilingual hub
                          (``--fused [--qrels]``: 2k-deep search and the
                          collapse on the device; parallel hubs only)
run-rerank                two-stage search: dense recall + MaxSim rerank
                          (two or more ``--index``: the bilingual hub)
serve                     online HTTP search with request coalescing
                          (``--token_store``: two-stage serving)
cache-queries             pre-encode query TSVs into npz caches
convert                   convert an HF checkpoint to ``params.npz`` +
                          ``encoder_config.json`` (``--weight_quant``:
                          quantized kernels on disk)
profile                   a ``torch.profiler`` trace of a search workload
tune                      time the top-k cover and flash dispatch
                          constants on the card into the tuned store
                          (``--sketch_index``: calibrate a sketch tier)
evaluate                  evaluate a TREC run against qrels
analyze                   embedding-space geometry of EN/ZH/CM query
                          triplets (the hubness k-NN on the card)
make-plan                 a sweep-plan JSON from the built-in matrices
                          (all-pairs / en-zh-repro / ablation)
sweep                     run a plan's jobs, each a ``python -m
                          codemix_dense_retrieval_torch`` process
collect                   aggregate result trees into CSV summaries
paper-values              the paper's statistics report over a results tree
plots                     the paper's figures over a results tree
generate-bands            code-mix band query sets (needs ``openai`` and
                          network)
download-queries          mMARCO dev queries to TSVs (needs ``datasets``
                          and network)
========================  ==============================================

Flags are the JAX package's, plus ``--device {cuda,cpu}`` (default cuda).
Corpus and query TSVs, index and token-store directories, TREC runs and
eval artifacts keep the same on-disk formats. ``--approx fast|guaranteed``
searches through the sketch tier, ``--approx adaptive`` through the
probed-exact tier (``run-rerank`` takes ``--approx`` for its dense stage,
which the JAX CLI does not); ``encode-corpus --pack`` packs passages into
shared rows; ``--weight_quant {int8,nf4}`` quantizes the encoder's
Linear weights (a pre-quantized ``convert`` checkpoint loads quantized
without it). ``--shards S`` row-shards every index over S devices (default
-1: every visible card; on the card S > the cards visible raises, on
``--device cpu`` S shards share the CPU) and ``--dp N`` makes the encoder
data-parallel over N devices (the same rules); ``--fused --approx
adaptive`` exits with the JAX package's error. With ``CDR_PROFILE_DIR``
set, ``encode-corpus``, ``run-mono`` and ``run-mix`` write a
``torch.profiler`` trace of their work and the totals of the port's spans
and counters (``trace.json``, ``spans.json``) under ``<dir>/<command>/``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from codemix_dense_retrieval_torch.config import DEFAULT_ALPHAS
from codemix_dense_retrieval_torch.utils.logging import get_logger, setup_logging

log = get_logger("cli")


def _parse_lang_path(specs: Sequence[str]) -> Dict[str, pathlib.Path]:
    """Parse repeated ``LANG=PATH`` arguments."""
    out: Dict[str, pathlib.Path] = {}
    for spec in specs:
        if "=" not in spec:
            raise SystemExit(f"[ERROR] expected LANG=PATH, got {spec!r}")
        lang, path = spec.split("=", 1)
        out[lang] = pathlib.Path(path)
    return out


_FUSED_ADAPTIVE = (
    "--fused does not support --approx adaptive: the probed-exact escalation is host-driven and "
    "cannot run inside the one-jit sweep (use --approx guaranteed for exact output, or drop --fused)"
)


def _reject_unported(args) -> None:
    if getattr(args, "fused", False) and getattr(args, "approx", "off") == "adaptive":
        raise SystemExit(_FUSED_ADAPTIVE)


def _mesh(args, size: int):
    """A ``size``-shard mesh on ``--device``: the visible cards (-1: all;
    more than visible raises), or ``size`` shards on the CPU (-1: one)."""
    from codemix_dense_retrieval_torch.parallel.mesh import make_mesh

    if args.device == "cpu":
        return make_mesh(shard=size, devices=["cpu"] * max(1, size))
    return make_mesh(shard=size)


def _encode_mesh(args):
    """The data-parallel encode mesh from ``--dp`` (1: one device, no mesh;
    -1: every device of ``--device``)."""
    return None if args.dp == 1 else _mesh(args, args.dp)


def _approx_mode(args):
    """--approx {off,fast,guaranteed,adaptive} -> the DenseFlatIndex.search value."""
    return {"off": False, "fast": True, "guaranteed": "guaranteed", "adaptive": "adaptive"}[
        getattr(args, "approx", "off")]


def _build_encoder(args):
    """TextEncoder from --encoder/--checkpoint via the registry; a tiny
    random-init f32 model + hash tokenizer when no checkpoint (smoke mode)."""
    if args.checkpoint:
        from codemix_dense_retrieval_torch.models.registry import load_encoder

        return load_encoder(args.encoder, args.checkpoint, seed=args.seed, device=args.device,
                            mesh=_encode_mesh(args), weight_quant=args.weight_quant)
    log.warning("no --checkpoint: random-init encoder + hash tokenizer (smoke mode)")
    from codemix_dense_retrieval_torch.models.dialects import default_pooling
    from codemix_dense_retrieval_torch.models.encoder import TextEncoder
    from codemix_dense_retrieval_torch.models.xlmr import XLMRConfig

    cfg = XLMRConfig.tiny(
        vocab_size=30_000,
        hidden_size=args.smoke_dim,
        num_heads=4,
        intermediate_size=args.smoke_dim * 4,
        pooling=default_pooling(args.encoder),
        use_flash=False,
    )
    return TextEncoder(args.encoder, cfg, seed=args.seed, device=args.device, mesh=_encode_mesh(args),
                       weight_quant=args.weight_quant)


def _load_query_sets(args) -> Dict[str, List[Tuple[str, str]]]:
    """A directory of band files (queries-cm*.tsv), single TSV files, or an
    HF streaming split (``--queries_repo``; needs the ``datasets`` package)."""
    from codemix_dense_retrieval_torch.io.tsv import read_queries_tsv

    sets: Dict[str, List[Tuple[str, str]]] = {}
    if getattr(args, "queries_repo", None):
        try:
            from datasets import load_dataset
        except ImportError as e:
            raise SystemExit(
                "[ERROR] --queries_repo needs the `datasets` package, which is not installed; "
                "export the queries to a `qid<TAB>text` TSV and pass --queries instead"
            ) from e
        ds = load_dataset(args.queries_repo, args.queries_config, split=args.queries_split, streaming=True)
        rows = []
        for rec in ds:
            rows.append((str(rec[args.qid_field]), rec[args.qtext_field]))
            if args.max_queries and len(rows) >= args.max_queries:
                break
        sets[args.queries_config or "hf"] = rows
        return sets
    for spec in args.queries or []:
        p = pathlib.Path(spec)
        if p.is_dir():
            for f in sorted(p.glob("queries-cm*.tsv")):
                sets[f.stem.replace("queries-", "")] = read_queries_tsv(f)
        else:
            sets[p.stem] = read_queries_tsv(p)
    if not sets:
        raise SystemExit("[ERROR] no query sets found")
    return sets


# ---------------------------------------------------------------------------
# commands
# ---------------------------------------------------------------------------

def cmd_encode_corpus(args) -> None:
    from codemix_dense_retrieval_torch.pipeline.corpus import (
        HFCorpusSource,
        SelectionState,
        TsvCorpusSource,
        encode_corpus,
    )
    from codemix_dense_retrieval_torch.utils.profiling import maybe_trace

    _reject_unported(args)
    sources = {}
    if args.corpus_tsv:
        for lang, path in _parse_lang_path(args.corpus_tsv).items():
            sources[lang] = TsvCorpusSource(path, lang)
    elif args.repo:
        for lang in args.langs:
            sources[lang] = HFCorpusSource(args.repo, f"collection-{lang}")
    else:
        raise SystemExit("[ERROR] need --corpus_tsv or --repo")
    encoder = _build_encoder(args)

    rel_ids = set()
    if args.rel_ids:
        rel_ids = set(pathlib.Path(args.rel_ids).read_text().split())
    elif args.rel_qrels:
        from codemix_dense_retrieval_torch.io.tsv import read_qrels

        qr = read_qrels(args.rel_qrels)
        rel_ids = {d for judged in qr.values() for d, r in judged.items() if r > 0}
        log.info("harvested %d relevant docids from %s", len(rel_ids), args.rel_qrels)
    selection = SelectionState(
        rel_ids=rel_ids,
        subset_neg_cap=args.subset_neg_cap,
        neg_prob=args.neg_prob,
        seed=args.seed,
    )
    with maybe_trace("encode-corpus"):
        dirs = encode_corpus(
            encoder,
            sources,
            args.out,
            selection=selection,
            batch_size=args.batch,
            enc_batch=args.enc_batch,
            max_docs=args.max_docs,
            storage_dtype=args.storage_dtype,
            force=args.force,
            tokens_per_doc=args.tokens_per_doc,
            token_dtype=args.token_dtype,
            pack=args.pack,
        )
    print(json.dumps({lang: str(d) for lang, d in dirs.items()}, indent=2))


def cmd_run_mono(args) -> None:
    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex
    from codemix_dense_retrieval_torch.pipeline.runs import run_word_mix_search
    from codemix_dense_retrieval_torch.utils.profiling import maybe_trace

    _reject_unported(args)
    encoder = _build_encoder(args)
    index = DenseFlatIndex.load(args.index).to_device(_mesh(args, args.shards))
    sets = _load_query_sets(args)
    if args.max_queries:
        sets = {k: v[: args.max_queries] for k, v in sets.items()}
    with maybe_trace("run-mono"):
        runs = run_word_mix_search(
            index, encoder, sets, args.outdir, k=args.k, batch_size=args.enc_batch,
            query_block=args.qblock, approx=_approx_mode(args),
        )
    print(json.dumps({k: str(v) for k, v in runs.items()}, indent=2))


def cmd_run_rerank(args) -> None:
    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex
    from codemix_dense_retrieval_torch.io.token_shards import TokenShardStore
    from codemix_dense_retrieval_torch.pipeline.rerank import (
        run_two_stage_bilingual,
        run_two_stage_search,
    )

    _reject_unported(args)
    encoder = _build_encoder(args)
    indexes, stores = [], []
    for ix_dir in args.index:
        tok_dir = pathlib.Path(ix_dir) / "tokens"
        if not TokenShardStore.exists(tok_dir):
            raise SystemExit(
                f"[ERROR] {tok_dir} is not a token store: re-run encode-corpus with --tokens_per_doc"
            )
        indexes.append(DenseFlatIndex.load(ix_dir).to_device(_mesh(args, args.shards)))
        stores.append(TokenShardStore.open(tok_dir))
    sets = _load_query_sets(args)
    if args.max_queries:
        sets = {k: v[: args.max_queries] for k, v in sets.items()}
    common = dict(k=args.k, k_dense=args.k_dense or None, batch_size=args.enc_batch,
                  query_block=args.qblock, cache_root=args.query_cache, approx=_approx_mode(args))
    if len(indexes) == 1:
        runs = run_two_stage_search(indexes[0], stores[0], encoder, sets, args.outdir, **common)
    else:
        # the bilingual hub: per-language two-stage + merge + collapse (the
        # queries are shared, so one query cache serves all languages)
        runs = run_two_stage_bilingual(indexes, stores, encoder, sets, args.outdir, **common)
    print(json.dumps({k: str(v) for k, v in runs.items()}, indent=2))


def cmd_run_mix(args) -> None:
    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex
    from codemix_dense_retrieval_torch.io.tsv import read_queries_tsv
    from codemix_dense_retrieval_torch.pipeline.query_cache import (
        QueryCacheMismatch,
        load_query_cache,
        save_query_cache,
    )
    from codemix_dense_retrieval_torch.pipeline.runs import (
        intersect_query_sets,
        run_vector_mix_search,
    )
    from codemix_dense_retrieval_torch.utils.profiling import maybe_trace

    _reject_unported(args)
    encoder = _build_encoder(args)
    index = DenseFlatIndex.load(args.index).to_device(_mesh(args, args.shards))
    tsvs = _parse_lang_path(args.query_tsv)
    if len(tsvs) != 2:
        raise SystemExit("[ERROR] run-mix needs exactly two LANG=PATH --query_tsv")
    (lang_a, path_a), (lang_b, path_b) = tsvs.items()
    qids, texts_a, texts_b = intersect_query_sets(
        read_queries_tsv(path_a), read_queries_tsv(path_b)
    )
    if not qids:
        raise SystemExit("[ERROR] empty qid intersection between the two query TSVs")

    def encode_cached(lang, texts):
        if args.query_cache:
            cache = pathlib.Path(args.query_cache) / lang / "queries.npz"
            if cache.exists():
                try:
                    _, vecs = load_query_cache(cache, expected_qids=qids)
                    return vecs
                except QueryCacheMismatch:
                    log.warning("stale query cache %s; re-encoding", cache)
            vecs = encoder.encode_queries(texts, batch_size=args.enc_batch)
            save_query_cache(cache, qids, vecs)
            return vecs
        return encoder.encode_queries(texts, batch_size=args.enc_batch)

    alphas = [float(a) for a in args.cm_alphas]
    approx = _approx_mode(args)
    with maybe_trace("run-mix"):
        vecs_a = encode_cached(lang_a, texts_a)
        vecs_b = encode_cached(lang_b, texts_b)
        if args.fused:
            _run_mix_fused(args, index, qids, vecs_a, vecs_b, alphas, approx)
            return
        runs = run_vector_mix_search(
            index, qids, vecs_a, vecs_b, alphas, args.outdir, k=args.k, query_block=args.qblock,
            approx=approx, write_meta=bool(approx),  # the meta carries the certificate rate
        )
    print(json.dumps({str(a): str(p) for a, p in runs.items()}, indent=2))


def _run_mix_fused(args, index, qids, vecs_a, vecs_b, alphas, approx) -> None:
    """``run-mix --fused``: the sweep on the device (+ its metrics when
    ``--qrels`` is given); run files are written either way, and one JSON
    payload per alpha is printed."""
    from codemix_dense_retrieval_torch.config import format_alpha
    from codemix_dense_retrieval_torch.evals.device_metrics import qrels_rel_matrix
    from codemix_dense_retrieval_torch.io.trec import write_run
    from codemix_dense_retrieval_torch.pipeline.fused import sweep_index

    rel_matrix, extra_zero = None, 0
    if args.qrels:
        from codemix_dense_retrieval_torch.io.tsv import read_qrels

        rel_matrix, extra_zero = qrels_rel_matrix(qids, read_qrels(args.qrels), index.docids)
    vals, ids, metrics, cert = sweep_index(
        index, vecs_a, vecs_b, alphas, args.k, approx=approx, rel_ids=rel_matrix,
        metric_extra_zero_queries=extra_zero, query_block=args.qblock,
    )
    outdir = pathlib.Path(args.outdir)
    out = {}
    for ai, alpha in enumerate(alphas):
        label = format_alpha(alpha)
        path = outdir / f"cm-alpha-{label}.trec"
        write_run(path, qids, ids[ai], vals[ai], tag="onepass-cm", table=index.docid_table())
        out[label] = {
            "run": str(path),
            **({name: round(float(v[ai]) * 100, 4) for name, v in metrics.items()} if metrics else {}),
        }
        if cert is not None:
            # guaranteed: the rate before escalation (the share that skipped
            # exact search; the runs are exact either way)
            out[label]["certified_frac"] = round(float(cert[ai].mean()), 4)
            out[label]["approx"] = "guaranteed" if approx == "guaranteed" else "fast"
    print(json.dumps(out, indent=2))


def _load_hub(args):
    """The per-language ``--index`` stores as one hub (``DenseFlatIndex.merged``,
    derived ids ``base#tag`` with ``--lang_tags`` or each store's language),
    on the ``--shards`` mesh."""
    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex

    indexes = [DenseFlatIndex.load(p) for p in args.index]
    tags = args.lang_tags or [ix.store.manifest.lang or str(i) for i, ix in enumerate(indexes)]
    hub = DenseFlatIndex.merged(indexes, lang_tags=tags) if len(indexes) > 1 else indexes[0]
    return hub.to_device(_mesh(args, args.shards))


def cmd_run_bilingual(args) -> None:
    from codemix_dense_retrieval_torch.pipeline.bilingual import run_bilingual_word_mix

    _reject_unported(args)
    encoder = _build_encoder(args)
    hub = _load_hub(args)
    sets = _load_query_sets(args)
    runs = run_bilingual_word_mix(
        hub, encoder, sets, args.outdir, k=args.k, batch_size=args.enc_batch, query_block=args.qblock,
        approx=_approx_mode(args),
    )
    print(json.dumps({k: str(v) for k, v in runs.items()}, indent=2))


def cmd_run_bilingual_mix(args) -> None:
    from codemix_dense_retrieval_torch.config import format_alpha
    from codemix_dense_retrieval_torch.io.tsv import read_queries_tsv
    from codemix_dense_retrieval_torch.pipeline.bilingual import (
        run_bilingual_vector_mix,
        run_bilingual_vector_mix_fused,
    )
    from codemix_dense_retrieval_torch.pipeline.runs import intersect_query_sets

    _reject_unported(args)
    encoder = _build_encoder(args)
    hub = _load_hub(args)
    tsvs = _parse_lang_path(args.query_tsv)
    if len(tsvs) != 2:
        raise SystemExit("[ERROR] need exactly two LANG=PATH --query_tsv")
    (lang_a, path_a), (lang_b, path_b) = tsvs.items()
    qids, texts_a, texts_b = intersect_query_sets(read_queries_tsv(path_a), read_queries_tsv(path_b))
    vecs_a = encoder.encode_queries(texts_a, batch_size=args.enc_batch)
    vecs_b = encoder.encode_queries(texts_b, batch_size=args.enc_batch)
    alphas = [float(a) for a in args.cm_alphas]
    if args.fused:
        qrels = None
        if args.qrels:
            from codemix_dense_retrieval_torch.io.tsv import read_qrels

            qrels = read_qrels(args.qrels)
        try:
            runs, metrics = run_bilingual_vector_mix_fused(
                hub, qids, vecs_a, vecs_b, alphas, args.outdir, k=args.k, qrels=qrels,
                approx=_approx_mode(args), query_block=args.qblock,
            )
        except ValueError as e:
            raise SystemExit(
                f"[ERROR] --fused requires a parallel hub: {e}\n"
                "        Re-run without --fused to use the host-side collapse (handles non-parallel hubs)."
            )
        payload = {
            str(a): {"run": str(p), **(metrics.get(format_alpha(a), {}) if metrics else {})}
            for a, p in runs.items()
        }
        print(json.dumps(payload, indent=2))
        return
    runs = run_bilingual_vector_mix(
        hub, qids, vecs_a, vecs_b, alphas, args.outdir, k=args.k, query_block=args.qblock,
        approx=_approx_mode(args),
    )
    print(json.dumps({str(a): str(p) for a, p in runs.items()}, indent=2))


def cmd_serve(args) -> None:
    """Online search: load the encoder and the index (one store, or several
    merged into a hub) and serve the coalescing HTTP endpoint
    (:mod:`~codemix_dense_retrieval_torch.serving`) until interrupted."""
    from codemix_dense_retrieval_torch.serving import SearchService, make_server

    _reject_unported(args)
    encoder = _build_encoder(args)
    index = _load_hub(args)
    mode = False if args.approx == "off" else args.approx
    if mode in ("fast", "guaranteed"):
        index.enable_sketch(sketch_dim=args.sketch_dim, probe_bins=args.probe_bins or None)
    search_kwargs = {}
    if mode == "adaptive":
        # no sidecar, but the persisted operating points apply
        index.load_adaptive_calibration()
        if args.probe_bins:
            search_kwargs["probe_bins"] = args.probe_bins
    if args.token_store:
        # two-stage serving; the dense stage stays exact (guaranteed or
        # adaptive), so the candidate pool is exact serving's
        from codemix_dense_retrieval_torch.io.token_shards import TokenShardStore
        from codemix_dense_retrieval_torch.pipeline.rerank import TwoStageSearcher

        index = TwoStageSearcher(
            index, TokenShardStore.open(args.token_store),
            approx="adaptive" if mode == "adaptive" else ("guaranteed" if mode else False),
        )
        if args.k_dense:
            search_kwargs["k_dense"] = args.k_dense
    service = SearchService(
        encoder, index, default_k=args.k, max_k=args.max_k, max_batch=args.max_batch,
        max_wait_s=args.max_wait_ms / 1000.0, encode_batch=args.enc_batch,
        approx=mode if not args.token_store else False, snapshot_root=args.snapshot_root,
        index_search_kwargs=search_kwargs,
    )
    if args.warm:
        print(json.dumps({"warmup": service.warmup()}), flush=True)
    server = make_server(service, host=args.host, port=args.port, info={"model": args.encoder, "docs": index.count})
    host, port = server.server_address[:2]
    print(json.dumps({"serving": f"http://{host}:{port}", "docs": index.count}), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()


def cmd_cache_queries(args) -> None:
    from codemix_dense_retrieval_torch.io.tsv import read_queries_tsv
    from codemix_dense_retrieval_torch.pipeline.query_cache import save_query_cache
    from codemix_dense_retrieval_torch.pipeline.runs import intersect_query_sets

    _reject_unported(args)
    encoder = _build_encoder(args)
    tsvs = _parse_lang_path(args.query_tsv)
    rows_by_lang = {lang: read_queries_tsv(p) for lang, p in tsvs.items()}
    if len(rows_by_lang) == 2:
        (la, ra), (lb, rb) = rows_by_lang.items()
        qids, ta, tb = intersect_query_sets(ra, rb)
        per_lang = {la: (qids, ta), lb: (qids, tb)}
    else:
        per_lang = {lang: ([q for q, _ in rows], [t for _, t in rows]) for lang, rows in rows_by_lang.items()}
    for lang, (qids, texts) in per_lang.items():
        vecs = encoder.encode_queries(texts, batch_size=args.enc_batch)
        out = pathlib.Path(args.cache_root) / lang / "queries.npz"
        save_query_cache(out, qids, vecs)
        print(f"{lang}: {out} ({len(qids)} queries)")


def cmd_convert(args) -> None:
    """Convert an HF checkpoint directory of any family to ``params.npz`` +
    ``encoder_config.json`` (the JAX package's format; its ``convert``
    takes the XLM-R family only); ``--weight_quant`` stores the Linear
    kernels quantized (2x / ~4x smaller than f32, loaded quantized)."""
    from codemix_dense_retrieval_torch.models.convert import flax_from_state_dict, save_params_npz
    from codemix_dense_retrieval_torch.models.encoder import checkpoint_config_dict
    from codemix_dense_retrieval_torch.models.registry import load_hf_family
    from codemix_dense_retrieval_torch.ops.weight_quant import quantize_tree

    cfg, params, _ = load_hf_family(args.encoder, args.src)
    tree = flax_from_state_dict(params)
    if args.weight_quant:
        tree = quantize_tree(tree, args.weight_quant)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    save_params_npz(out / "params.npz", tree)
    (out / "encoder_config.json").write_text(json.dumps(checkpoint_config_dict(cfg), indent=2))
    tok = pathlib.Path(args.src) / "tokenizer.json"
    if tok.exists():
        (out / "tokenizer.json").write_text(tok.read_text(encoding="utf-8"), encoding="utf-8")
    print(f"converted {args.src} -> {out} ({cfg.num_layers} layers, dim {cfg.hidden_size})")


def cmd_profile(args) -> None:
    """A ``torch.profiler`` trace (``--trace_dir`` or ``CDR_PROFILE_DIR``;
    a Chrome trace under ``<dir>/search/``) around a search workload over
    ``--index`` or a synthetic one; prints the timing JSON, with the port's
    span totals under ``spans`` (empty without a trace: spans record only
    while the profiler runs)."""
    import numpy as np

    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex
    from codemix_dense_retrieval_torch.utils import timing
    from codemix_dense_retrieval_torch.utils.profiling import maybe_trace, timed_device_fn

    _reject_unported(args)
    if args.index:
        index = DenseFlatIndex.load(args.index)
    else:
        rng = np.random.default_rng(args.seed)
        vecs = rng.standard_normal((args.docs, args.dim), dtype=np.float32)
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        index = DenseFlatIndex.build(vecs, [str(i) for i in range(args.docs)])
        del vecs
    index.to_device(_mesh(args, args.shards))
    rng = np.random.default_rng(args.seed + 1)
    q = rng.standard_normal((args.queries, index.dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    approx = _approx_mode(args)
    if approx == "adaptive":
        index.load_adaptive_calibration()
    elif approx:
        index.enable_sketch()
    # the kernels' first-use build and allocations happen outside the trace
    index.search(q, args.k, return_docids=False, approx=approx)
    with maybe_trace("search", args.trace_dir):
        stats = timed_device_fn(
            lambda: index.search(q, args.k, return_docids=False, approx=approx), iters=args.iters,
        )
    stats["spans"] = timing.totals()
    if approx and index.last_certified is not None:
        stats["certified_frac"] = float(index.last_certified.mean())
    stats.update(
        queries=args.queries, k=args.k, docs=index.count,
        qps=round(args.queries / stats["mean_s"], 1) if stats.get("mean_s") else None,
        trace_dir=args.trace_dir, device=str(index.device),
    )
    print(json.dumps(stats))


def cmd_tune(args) -> None:
    """Time the two-level cover's G / M / tile_b per depth and the
    flash/plain crossover on the card, and persist the winners to the
    tuned store (``CDR_TUNE_FILE`` or a file per card kind under
    ``~/.cache``; ``--dry_run`` prints them only). ``--sketch_index``
    also calibrates that index's sketch tier (and ``--adaptive`` its
    probed-exact tier) on self-retrieval probes; those operating points
    persist in the index's ``sketch.npz``."""
    from codemix_dense_retrieval_torch.utils.autotune import run_autotune, tune_file_path

    _reject_unported(args)
    update = run_autotune(
        topk=not args.skip_topk, flash=not args.skip_flash, save=not args.dry_run,
        rows=args.rows, dim=args.dim, batch=args.batch, ks=tuple(args.ks), iters=args.iters,
        device=args.device,
    )
    update["tune_file"] = None if args.dry_run else str(tune_file_path())
    if args.sketch_index:
        import numpy as np

        from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex
        from codemix_dense_retrieval_torch.io.shards import storage_to_tensor

        idx = DenseFlatIndex.load(args.sketch_index)
        idx.to_device(_mesh(args, args.shards))
        idx.enable_sketch(sketch_dim=args.sketch_dim)
        n_probe = min(512, idx.count)
        stride = max(1, idx.count // n_probe)
        probes = storage_to_tensor(
            np.ascontiguousarray(idx.store.vectors[::stride][:n_probe]), idx.store.manifest.dtype
        ).float().numpy()
        update["sketch"] = {
            str(kk): idx.calibrate_sketch(probes, kk, recall_target=args.sketch_recall) for kk in args.ks
        }
        if args.adaptive:
            update["adaptive"] = {str(kk): idx.calibrate_adaptive(probes, kk) for kk in args.ks}
    print(json.dumps(update))


def cmd_generate_bands(args) -> None:
    """Generate code-mix band query sets (reference generate_cm_bands.py)."""
    from codemix_dense_retrieval_torch.datagen.bands import (
        UsageTracker,
        generate_band_dataset,
        openai_band_generate_fn,
        openai_generate_fn,
    )
    from codemix_dense_retrieval_torch.io.tsv import read_queries_tsv, write_queries_tsv
    from codemix_dense_retrieval_torch.pipeline.runs import intersect_query_sets

    qids, texts_en, texts_zh = intersect_query_sets(read_queries_tsv(args.en), read_queries_tsv(args.zh))
    if args.max_queries:
        qids, texts_en, texts_zh = (
            qids[: args.max_queries], texts_en[: args.max_queries], texts_zh[: args.max_queries]
        )
    bands = []
    for spec in args.bands:
        lo, hi = spec.split("-")
        bands.append((int(lo), int(hi)))
    usage = UsageTracker()
    if args.protocol == "kadapt":
        gen = openai_band_generate_fn(model=args.model, usage=usage)
    else:
        gen = openai_generate_fn(model=args.model, usage=usage)
    generate_band_dataset(
        list(zip(qids, texts_en, texts_zh)), args.out_dir, gen, bands=bands, num_threads=args.workers,
        kadapt=args.protocol == "kadapt",
    )
    # pure-language endpoint bands used by the word-mix runs
    out = pathlib.Path(args.out_dir)
    write_queries_tsv(out / "queries-cm0.tsv", list(zip(qids, texts_en)))
    write_queries_tsv(out / "queries-cm100.tsv", list(zip(qids, texts_zh)))
    print(json.dumps({"out_dir": str(out), "queries": len(qids), **usage.summary()}))


def cmd_download_queries(args) -> None:
    from codemix_dense_retrieval_torch.datagen.download import download_mmarco_queries

    download_mmarco_queries(args.langs, args.out, repo=args.repo, split_prefix=args.split_prefix)


def cmd_analyze(args) -> None:
    """Embedding-space geometry over EN/ZH/CM query triplets: the encode
    and the hubness k-NN on ``--device``, the rest host numpy; the probe
    and the projections need scikit-learn, the figure matplotlib."""
    import numpy as np

    from codemix_dense_retrieval_torch.analysis.embedding_space import (
        analyze_triplets,
        plot_projection,
        project_embeddings,
        write_report,
    )
    from codemix_dense_retrieval_torch.analysis.plots import write_projection_html
    from codemix_dense_retrieval_torch.io.tsv import read_queries_tsv
    from codemix_dense_retrieval_torch.pipeline.runs import intersect_query_sets

    _reject_unported(args)
    encoder = _build_encoder(args)
    tsvs = _parse_lang_path(args.query_tsv)
    if len(tsvs) != 3:
        raise SystemExit("[ERROR] analyze needs three LANG=PATH --query_tsv (en, zh, cm)")
    (l_a, p_a), (l_b, p_b), (l_cm, p_cm) = tsvs.items()
    rows_cm = dict(read_queries_tsv(p_cm))
    qids, texts_a, texts_b = intersect_query_sets(read_queries_tsv(p_a), read_queries_tsv(p_b))
    # filter by index so texts stay aligned with their qids when the CM set
    # lacks an intersected qid
    keep = [i for i, q in enumerate(qids) if q in rows_cm]
    qids = [qids[i] for i in keep]
    texts_a = [texts_a[i] for i in keep]
    texts_b = [texts_b[i] for i in keep]
    texts_cm = [rows_cm[q] for q in qids]
    if not qids:
        raise SystemExit("[ERROR] empty qid intersection across the three TSVs")
    E_a = encoder.encode_queries(texts_a, batch_size=args.enc_batch)
    E_b = encoder.encode_queries(texts_b, batch_size=args.enc_batch)
    E_cm = encoder.encode_queries(texts_cm, batch_size=args.enc_batch)
    result = analyze_triplets(E_a, E_b, E_cm, seed=args.seed, device=args.device)
    outdir = pathlib.Path(args.outdir)
    write_report(result, outdir, qids=qids)
    proj = project_embeddings(E_a, E_b, E_cm, seed=args.seed)
    plot_projection(proj, outdir / "projection.png")
    # the interactive 3-D projection (the reference's plotly output)
    proj3 = project_embeddings(E_a, E_b, E_cm, seed=args.seed, n_components=3)
    pts3 = np.vstack([proj3["en"], proj3["zh"], proj3["cm"]])
    groups = [0] * len(proj3["en"]) + [1] * len(proj3["zh"]) + [2] * len(proj3["cm"])
    write_projection_html(pts3, groups, [l_a.upper(), l_b.upper(), l_cm.upper()], outdir / "projection_3d.html")
    print(json.dumps(result.summary(), indent=2, default=float))


def cmd_sweep(args) -> None:
    from codemix_dense_retrieval_torch.orchestrate.scheduler import run_sweep_cli

    run_sweep_cli(args)


def cmd_make_plan(args) -> None:
    """A sweep-plan JSON from the built-in experiment matrices (the
    reference's bash job tables); its jobs run this CLI."""
    from codemix_dense_retrieval_torch.orchestrate import plans as P

    if args.kind in ("all-pairs", "en-zh-repro") and not args.index_root:
        raise SystemExit(f"[ERROR] {args.kind} needs --index_root")
    runner_args = []
    for spec in args.runner_arg or []:
        runner_args.extend(spec.split())
    if args.kind == "all-pairs":
        plan = P.build_all_pairs_plan(
            index_root=args.index_root, query_tsv_root=args.query_tsv_root,
            result_root=args.result_root, encoder=args.encoder,
            checkpoint=args.checkpoint, qrels=args.qrels, size=args.size,
            k=args.k, extra_runner_args=runner_args,
        )
    elif args.kind == "en-zh-repro":
        plan = P.build_en_zh_repro_plan(
            index_root=args.index_root,
            query_tsv_en=str(pathlib.Path(args.query_tsv_root) / "queries.en.tsv"),
            query_tsv_zh=str(pathlib.Path(args.query_tsv_root) / "queries.zh.tsv"),
            band_dir=args.band_dir, result_root=args.result_root,
            encoder=args.encoder, checkpoint=args.checkpoint,
            qrels=args.qrels, size=args.size,
            k=args.k, extra_runner_args=runner_args,
        )
    else:  # ablation
        roots = dict(kv.split("=", 1) for kv in (args.index_root_by_model or []))
        if not roots:
            raise SystemExit("[ERROR] ablation needs --index_root_by_model TAG=ROOT ...")
        cps = dict(kv.split("=", 1) for kv in (args.checkpoints or []))
        plan = P.build_ablation_plan(
            index_root_by_model=roots, query_tsv_root=args.query_tsv_root,
            result_root=args.result_root, checkpoints=cps, qrels=args.qrels,
            size=args.size,
        )
    out = P.write_plan(plan, args.out)
    print(json.dumps({"plan": str(out), "jobs": len(plan["jobs"])}))


def cmd_collect(args) -> None:
    if args.ablation:
        from codemix_dense_retrieval_torch.analysis.ablation import collect_ablation_cli

        collect_ablation_cli(args.results_root, args.out, reference_format=args.reference_format)
    else:
        from codemix_dense_retrieval_torch.analysis.collect import collect_cli

        collect_cli(args)


def cmd_paper_values(args) -> None:
    """The paper-statistics report over a results tree."""
    from codemix_dense_retrieval_torch.analysis.collect import collect_results, compute_summary
    from codemix_dense_retrieval_torch.analysis.paper_values import paper_values_report

    rows = collect_results(args.results_root)
    summary = compute_summary(rows)
    report = paper_values_report(summary, rows, n_boot=args.n_boot)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(report)
        print(f"wrote {out} ({len(summary)} summary rows)")
    else:
        print(report)


def cmd_plots(args) -> None:
    """The paper's figures over a results tree."""
    from codemix_dense_retrieval_torch.analysis.collect import collect_results, compute_summary
    from codemix_dense_retrieval_torch.analysis.plots import generate_all

    rows = collect_results(args.results_root)
    paths = generate_all(rows, compute_summary(rows), args.outdir)
    print(f"wrote {len(paths)} figures to {args.outdir}")


# ---------------------------------------------------------------------------

def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--encoder", default="BAAI/bge-m3")
    p.add_argument("--checkpoint", help="converted or HF checkpoint dir")
    p.add_argument("--smoke_dim", type=int, default=64, help="hidden size for random-init smoke mode")
    p.add_argument("--weight_quant", choices=("int8", "nf4"),
                   help="quantize the encoder's Linear weights on the device (the bitsandbytes "
                        "load_in_8bit/4bit analog)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--enc_batch", type=int, default=64)
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel encode devices (-1: all; on --device cpu, shards of the CPU)")
    p.add_argument("--shards", type=int, default=-1,
                   help="index shard axis size (-1: every visible card; on --device cpu, S CPU shards)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--verbosity", type=int, default=1)


def _add_query_source_flags(p) -> None:
    p.add_argument("--queries", nargs="+", help="band dir or TSV files")
    p.add_argument("--queries_repo", help="HF dataset repo (streaming query mode; needs `datasets`)")
    p.add_argument("--queries_config", default=None)
    p.add_argument("--queries_split", default="dev")
    p.add_argument("--qid_field", default="id")
    p.add_argument("--qtext_field", default="text")


def _add_approx_flag(p) -> None:
    p.add_argument("--approx", choices=["off", "fast", "guaranteed", "adaptive"], default="off",
                   help="search tier: 'fast' = PCA sketch, approximate (certificate rate in the "
                        "meta); 'guaranteed' escalates uncertified queries to exact search, so the "
                        "run files equal exact output; 'adaptive' = probed-exact cover (always exact, "
                        "fastest on cluster-ordered indexes; not supported inside --fused)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="codemix_dense_retrieval_torch",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("encode-corpus", help="encode per-language corpora into shard stores")
    _add_common(p)
    p.add_argument("--repo", help="HF dataset repo (e.g. unicamp-dl/mmarco; needs `datasets`)")
    p.add_argument("--langs", nargs="+", default=["english"])
    p.add_argument("--corpus_tsv", nargs="+", help="LANG=PATH offline corpus TSVs")
    p.add_argument("--out", required=True)
    p.add_argument("--rel_ids", help="file with relevant docids (subset mode)")
    p.add_argument("--rel_qrels", help="qrels file to harvest relevant docids from")
    p.add_argument("--subset_neg_cap", type=int, default=0)
    p.add_argument("--neg_prob", type=float, default=1.0)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--max_docs", type=int, default=0)
    p.add_argument("--storage_dtype", default="bfloat16",
                   choices=("bfloat16", "float32", "float16", "int8"))
    p.add_argument("--tokens_per_doc", type=int, default=0,
                   help="also write a token store of this many tokens per doc (two-stage MaxSim)")
    p.add_argument("--token_dtype", default="int8", help="storage dtype of the token store")
    p.add_argument("--pack", action="store_true",
                   help="sequence-packed encode: short passages share device rows under a "
                        "block-diagonal attention mask")
    p.add_argument("--force", action="store_true")
    p.set_defaults(fn=cmd_encode_corpus)

    p = sub.add_parser("run-mono", help="word-mix band search over one index")
    _add_common(p)
    p.add_argument("--index", required=True)
    _add_query_source_flags(p)
    p.add_argument("--outdir", required=True)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--qblock", type=int, default=256)
    p.add_argument("--max_queries", type=int, default=0)
    _add_approx_flag(p)
    p.set_defaults(fn=cmd_run_mono)

    p = sub.add_parser("run-mix", help="vector-mix alpha sweep over one index")
    _add_common(p)
    p.add_argument("--index", required=True)
    p.add_argument("--query_tsv", nargs=2, required=True, metavar="LANG=PATH")
    p.add_argument("--cm_alphas", nargs="+", default=[str(a) for a in DEFAULT_ALPHAS])
    p.add_argument("--query_cache")
    p.add_argument("--outdir", required=True)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--qblock", type=int, default=1024)
    p.add_argument("--fused", action="store_true",
                   help="the sweep on the device, with on-device metrics when --qrels is given")
    p.add_argument("--qrels", help="qrels file for --fused on-device metrics")
    _add_approx_flag(p)
    p.set_defaults(fn=cmd_run_mix)

    p = sub.add_parser("run-bilingual", help="bilingual hub word-mix search (collapse-max)")
    _add_common(p)
    p.add_argument("--index", nargs="+", required=True, help="per-language shard dirs")
    p.add_argument("--lang_tags", nargs="+")
    p.add_argument("--queries", nargs="+", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--k", type=int, default=500)
    p.add_argument("--qblock", type=int, default=256)
    _add_approx_flag(p)
    p.set_defaults(fn=cmd_run_bilingual)

    p = sub.add_parser("run-bilingual-mix", help="bilingual hub vector-mix sweep")
    _add_common(p)
    p.add_argument("--index", nargs="+", required=True)
    p.add_argument("--lang_tags", nargs="+")
    p.add_argument("--query_tsv", nargs=2, required=True, metavar="LANG=PATH")
    p.add_argument("--cm_alphas", nargs="+", default=[str(a) for a in DEFAULT_ALPHAS])
    p.add_argument("--outdir", required=True)
    p.add_argument("--k", type=int, default=500)
    p.add_argument("--qblock", type=int, default=1024)
    p.add_argument("--fused", action="store_true",
                   help="the sweep on the device: 2k-deep raw search + on-device collapse. The hub "
                        "must be a PARALLEL two-language concatenation (both halves encode the same "
                        "docid stream in the same order); other hubs are refused with an error. "
                        "Without --fused the host-side collapse handles any hub")
    p.add_argument("--qrels", help="qrels file for --fused on-device metrics")
    _add_approx_flag(p)
    p.set_defaults(fn=cmd_run_bilingual_mix)

    p = sub.add_parser(
        "run-rerank",
        help="two-stage search: dense recall + MaxSim token rerank "
             "(needs a token store from encode-corpus --tokens_per_doc)",
    )
    _add_common(p)
    p.add_argument("--index", nargs="+", required=True,
                   help="shard dir(s) with tokens/ substores; 2+ dirs = bilingual hub (merge + collapse)")
    _add_query_source_flags(p)
    p.add_argument("--outdir", required=True)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--k_dense", type=int, default=0, help="dense recall depth (0 = max(4k, 100))")
    p.add_argument("--qblock", type=int, default=256)
    p.add_argument("--max_queries", type=int, default=0)
    p.add_argument("--query_cache", help="dir for per-set dense+token query embedding caches")
    _add_approx_flag(p)
    p.set_defaults(fn=cmd_run_rerank)

    p = sub.add_parser("serve", help="online HTTP search endpoint with request coalescing "
                                     "(GET /healthz, POST /search {queries, k})")
    _add_common(p)
    p.add_argument("--index", nargs="+", required=True,
                   help="shard dir(s); several merge into one base#lang hub index")
    p.add_argument("--lang_tags", nargs="+")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--k", type=int, default=10, help="default result depth")
    p.add_argument("--max_k", type=int, default=1000)
    p.add_argument("--max_batch", type=int, default=256, help="max coalesced queries per device batch")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="max wait after the first request before dispatch")
    p.add_argument("--approx", nargs="?", const="fast", default="off",
                   choices=["off", "fast", "guaranteed", "adaptive"],
                   help="serve through a search tier: 'fast' = PCA sketch (each result row becomes "
                        "{hits, certified}); 'guaranteed' escalates uncertified queries to exact search; "
                        "'adaptive' = probed-exact cover (always exact). Bare --approx means 'fast'.")
    p.add_argument("--sketch_dim", type=int, default=128, help="sketch dimensionality for --approx")
    p.add_argument("--probe_bins", type=int, default=0, help="bins probed for --approx (0 = auto)")
    p.add_argument("--snapshot_root",
                   help="enable POST /save and /reload, restricted to this directory (unset: disabled)")
    p.add_argument("--token_store",
                   help="serve two-stage: dense recall + MaxSim rerank against this token store "
                        "(encode-corpus --tokens_per_doc); with --approx the dense stage runs guaranteed")
    p.add_argument("--k_dense", type=int, default=0, help="two-stage dense recall depth (0 = max(4k, 100))")
    p.add_argument("--warm", action="store_true",
                   help="drive every (batch, k) serving bucket before accepting traffic (the kernels' "
                        "first-use build and the card's allocations)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("cache-queries", help="pre-encode query TSVs into npz caches")
    _add_common(p)
    p.add_argument("--query_tsv", nargs="+", required=True, metavar="LANG=PATH")
    p.add_argument("--cache_root", required=True)
    p.set_defaults(fn=cmd_cache_queries)

    p = sub.add_parser("convert", help="convert an HF checkpoint to framework params")
    p.add_argument("--encoder", default="BAAI/bge-m3")
    p.add_argument("--src", required=True, help="HF checkpoint dir")
    p.add_argument("--out", required=True)
    p.add_argument("--weight_quant", choices=("int8", "nf4"),
                   help="persist Linear kernels quantized (2x/~4x smaller checkpoint; loads quantized)")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser(
        "profile",
        help="capture a torch.profiler trace of a search workload (trace.json, with the port's "
             "spans on rows of their own, and spans.json: their totals; spans record only while "
             "the profiler runs)",
    )
    _add_common(p)
    p.add_argument("--index", help="shard dir (omit for a synthetic index)")
    p.add_argument("--docs", type=int, default=100_000)
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--queries", type=int, default=1024)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--trace_dir", help="profiler output dir (also CDR_PROFILE_DIR)")
    _add_approx_flag(p)
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser(
        "tune",
        help="time kernel and routing constants on the card (G, M, tile_b per depth, the "
             "flash/plain crossover) into a per-card-kind store the dispatch reads",
    )
    _add_common(p)
    p.add_argument("--rows", type=int, default=262_144)
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--ks", type=int, nargs="+", default=[100, 1000])
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--skip_topk", action="store_true")
    p.add_argument("--skip_flash", action="store_true")
    p.add_argument("--dry_run", action="store_true", help="print winners without writing the store")
    p.add_argument("--sketch_index",
                   help="also calibrate the sketch tier's probe depths on this index dir (self-retrieval "
                        "probes; operating points persist in its sketch.npz)")
    p.add_argument("--sketch_dim", type=int, default=128)
    p.add_argument("--sketch_recall", type=float, default=0.99)
    p.add_argument("--adaptive", action="store_true",
                   help="with --sketch_index: also calibrate the adaptive probed-exact tier")
    p.set_defaults(fn=cmd_tune)

    sub.add_parser(
        "evaluate", help="evaluate a TREC run (all evaluate.py flags)", add_help=False,
    )

    p = sub.add_parser("generate-bands", help="generate code-mix band query sets (needs OPENAI_API_KEY)")
    p.add_argument("--en", required=True)
    p.add_argument("--zh", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--bands", nargs="+", default=["0-20", "20-40", "40-60", "60-80", "80-100"])
    p.add_argument("--model", default="gpt-5-mini")
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--max_queries", type=int, default=0)
    p.add_argument("--protocol", choices=["kadapt", "multi"], default="kadapt",
                   help="kadapt = reference-parity per-band K budgets (one JSON call per attempt); "
                        "multi = simple multi-candidate protocol")
    p.set_defaults(fn=cmd_generate_bands)

    p = sub.add_parser("download-queries", help="download mMARCO dev queries to TSVs")
    p.add_argument("--langs", nargs="+", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--repo", default="unicamp-dl/mmarco")
    p.add_argument("--split_prefix", default="queries-")
    p.set_defaults(fn=cmd_download_queries)

    p = sub.add_parser("analyze", help="embedding-space geometry analysis (EN/ZH/CM triplets)")
    _add_common(p)
    p.add_argument("--query_tsv", nargs=3, required=True, metavar="LANG=PATH")
    p.add_argument("--outdir", required=True)
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser(
        "make-plan",
        help="emit a sweep-plan JSON from the built-in matrices "
             "(all-pairs 105 jobs / en-zh-repro 6 jobs / ablation blocks)",
    )
    p.add_argument("kind", choices=["all-pairs", "en-zh-repro", "ablation"])
    p.add_argument("--index_root")
    p.add_argument("--index_root_by_model", nargs="+", metavar="TAG=ROOT")
    p.add_argument("--query_tsv_root", required=True, help="directory of queries.<lang>.tsv files")
    p.add_argument("--band_dir", help="word-mix band dir (en-zh-repro)")
    p.add_argument("--result_root", required=True)
    p.add_argument("--encoder", default="BAAI/bge-m3")
    p.add_argument("--checkpoint")
    p.add_argument("--checkpoints", nargs="+", metavar="TAG=PATH")
    p.add_argument("--qrels")
    p.add_argument("--size", type=int, default=100_000)
    p.add_argument("--k", type=int, help="search depth override for every job")
    p.add_argument("--runner_arg", action="append", metavar="'--flag value'",
                   help="extra args appended to every runner argv "
                        "(repeatable; e.g. --runner_arg '--device cpu --smoke_dim 32')")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_make_plan)

    p = sub.add_parser("sweep", help="experiment scheduler (replaces the bash schedulers)")
    p.add_argument("--plan", required=True, help="JSON sweep plan file")
    p.add_argument("--max_failures", type=int, default=1)
    p.add_argument("--slots", type=int, default=1,
                   help="concurrency when the plan has no device_slots table")
    p.add_argument("--dry_run", action="store_true")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("collect", help="aggregate result trees into CSV summaries")
    p.add_argument("--results_root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--ablation", action="store_true")
    p.add_argument("--reference_format", action="store_true",
                   help="emit the reference collector's CSV schema "
                        "(full_mmarco_results.csv columns, metrics x100)")
    p.set_defaults(fn=cmd_collect)

    p = sub.add_parser("paper-values", help="paper statistics report over a results tree")
    p.add_argument("--results_root", required=True)
    p.add_argument("--out", help="report path (stdout when omitted)")
    p.add_argument("--n_boot", type=int, default=2000)
    p.set_defaults(fn=cmd_paper_values)

    p = sub.add_parser("plots", help="paper figures over a results tree")
    p.add_argument("--results_root", required=True)
    p.add_argument("--outdir", required=True)
    p.set_defaults(fn=cmd_plots)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "evaluate":
        from codemix_dense_retrieval_torch.evals.evaluate import main as eval_main

        eval_main(argv[1:])
        return
    args = build_parser().parse_args(argv)
    setup_logging(getattr(args, "verbosity", 1))
    args.fn(args)


if __name__ == "__main__":
    main()
