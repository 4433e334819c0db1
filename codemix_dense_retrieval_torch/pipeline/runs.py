"""Monolingual search runners: word-mix band sets and vector-mix alpha
sweeps over a device-resident index.

Each runner searches one or many query sets (k=100 by default) and writes
one TREC run per band / alpha with the JAX package's file names and line
format, from the search's row ids and the index's docid table
(:meth:`~codemix_dense_retrieval_torch.index.flat.DenseFlatIndex.docid_table`,
built at the first write and kept across alphas). The alpha sweep keeps
the index on the card across all alphas and mixes on the device in f32
(:func:`~codemix_dense_retrieval_torch.ops.mix.mix_and_renorm`). While
tracing (:mod:`~codemix_dense_retrieval_torch.utils.timing`) each
alpha or set is the span ``runs.alpha`` (the mix inside it ``runs.mix``)
and counts its queries under ``runs.queries``.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from codemix_dense_retrieval_torch.config import format_alpha
from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex
from codemix_dense_retrieval_torch.io.trec import write_run
from codemix_dense_retrieval_torch.ops.mix import mix_and_renorm
from codemix_dense_retrieval_torch.utils import timing
from codemix_dense_retrieval_torch.utils.logging import get_logger

log = get_logger("runs")


def run_word_mix_search(
    index: DenseFlatIndex,
    encoder,
    query_sets: Dict[str, List[Tuple[str, str]]],
    outdir,
    *,
    k: int = 100,
    batch_size: int = 64,
    query_block: int = 256,
    tag: str = "onepass",
    max_queries: int = 0,
    approx=False,
) -> Dict[str, pathlib.Path]:
    """Encode + search each band's query set; one ``<set>.trec`` per set.

    ``approx``: search through the sketch tier (True = fast approximate,
    ``"guaranteed"`` = certificate-escalated, output identical to exact
    search); the certificate rate goes into ``<set>_meta.json``."""
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    out: Dict[str, pathlib.Path] = {}
    for set_name, rows in query_sets.items():
        if max_queries:
            rows = rows[:max_queries]
        qids = [q for q, _ in rows]
        texts = [t for _, t in rows]
        with timing.span("runs.alpha"):
            timing.count("runs.queries", len(qids))
            qvecs = encoder.encode_queries(texts, batch_size=batch_size)
            vals, ids = index.search(qvecs, k, query_block=query_block, approx=approx, return_docids=False)
            run_path = outdir / f"{set_name}.trec"
            write_run(run_path, qids, ids, vals, tag=tag, table=index.docid_table())
            out[set_name] = run_path
            if approx and index.last_certified is not None:
                (outdir / f"{set_name}_meta.json").write_text(json.dumps({
                    "approx": str(approx),
                    "certified_frac": float(index.last_certified.mean()),
                    "num_queries": len(qids), "k": k,
                }, indent=2))
        log.info("run saved: %s (%d queries)", run_path, len(qids))
    return out


def run_vector_mix_search(
    index: DenseFlatIndex,
    qids: Sequence[str],
    primary_vecs: np.ndarray,
    secondary_vecs: np.ndarray,
    alphas: Sequence[float],
    outdir,
    *,
    k: int = 100,
    query_block: int = 1024,
    tag: str = "onepass-cm",
    run_prefix: str = "cm-alpha-",
    write_meta: bool = False,
    meta_extra: Optional[Dict] = None,
    precision: int = 4,
    approx=False,
    cert_out: Optional[Dict[float, float]] = None,
) -> Dict[float, pathlib.Path]:
    """Alpha-sweep search with on-device mix + renorm.

    ``primary_vecs``/``secondary_vecs`` are the two monolingual query
    embedding matrices over the SAME qid order. Writes
    ``cm-alpha-<label>.trec`` per alpha. ``approx`` as in
    :func:`run_word_mix_search`; ``cert_out`` collects each alpha's
    certificate rate, and the meta carries it as ``certified_frac``."""
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    if index.device is None:
        index.to_device()
    p = torch.as_tensor(np.asarray(primary_vecs, np.float32), device=index.device)
    s = torch.as_tensor(np.asarray(secondary_vecs, np.float32), device=index.device)
    out: Dict[float, pathlib.Path] = {}
    for alpha in alphas:
        label = format_alpha(alpha)
        with timing.span("runs.alpha"):
            timing.count("runs.queries", len(qids))
            with timing.span("runs.mix"):
                q_matrix = mix_and_renorm(p, s, float(alpha))
            vals, ids = index.search(q_matrix, k, query_block=query_block, approx=approx, return_docids=False)
            if cert_out is not None and index.last_certified is not None:
                # per alpha, inside the loop: the index holds only the latest
                cert_out[alpha] = float(index.last_certified.mean())
            run_path = outdir / f"{run_prefix}{label}.trec"
            write_run(run_path, list(qids), ids, vals, tag=tag, precision=precision, table=index.docid_table())
            out[alpha] = run_path
            if write_meta:
                meta = {
                    "alpha": alpha,
                    "num_queries": len(qids),
                    "k": k,
                    "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
                }
                if approx and index.last_certified is not None:
                    meta["approx"] = str(approx)
                    meta["certified_frac"] = float(index.last_certified.mean())
                meta.update(meta_extra or {})
                (outdir / f"{run_prefix}{label}_meta.json").write_text(json.dumps(meta, indent=2))
        log.info("run saved: %s (%d queries, alpha=%s)", run_path, len(qids), label)
    return out


def intersect_query_sets(
    primary: Sequence[Tuple[str, str]], secondary: Sequence[Tuple[str, str]]
) -> Tuple[List[str], List[str], List[str]]:
    """qid intersection preserving primary order. Returns (common_qids,
    primary_texts, secondary_texts)."""
    sec = dict(secondary)
    qids, p_texts, s_texts = [], [], []
    for qid, text in primary:
        if qid in sec:
            qids.append(qid)
            p_texts.append(text)
            s_texts.append(sec[qid])
    return qids, p_texts, s_texts
