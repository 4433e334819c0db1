"""Bilingual hub runners: one index over two languages, k=500 search, raw
runs max-collapsed to base docids.

The hub is the per-language stores end to end (``DenseFlatIndex.merged``,
derived ids ``base#lang``). The unfused runners write ``<set>_raw.trec``,
collapse ``docid#lang`` by max score into ``<set>_base.trec``
(:func:`~codemix_dense_retrieval_torch.io.trec.collapse_run_max`) and write a
per-set ``_meta.json``; the fused runner searches 2k deep and collapses on
the device (:mod:`~codemix_dense_retrieval_torch.pipeline.fused`). File
names and formats are the JAX package's.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from codemix_dense_retrieval_torch.config import format_alpha
from codemix_dense_retrieval_torch.evals.device_metrics import qrels_rel_matrix
from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex
from codemix_dense_retrieval_torch.io.trec import RunEntry, collapse_run_max, write_run, write_run_entries
from codemix_dense_retrieval_torch.pipeline.fused import sweep_index
from codemix_dense_retrieval_torch.pipeline.runs import run_vector_mix_search
from codemix_dense_retrieval_torch.utils.logging import get_logger

log = get_logger("bilingual")


def _write_set_meta(outdir: pathlib.Path, set_name: str, meta: Dict) -> None:
    (outdir / f"{set_name}_meta.json").write_text(json.dumps(meta, indent=2))


def run_bilingual_word_mix(
    hub_index: DenseFlatIndex,
    encoder,
    query_sets: Dict[str, List[Tuple[str, str]]],
    outdir,
    *,
    k: int = 500,
    batch_size: int = 64,
    query_block: int = 256,
    tag: str = "bilingual-onepass",
    approx=False,
) -> Dict[str, pathlib.Path]:
    """Encode every band set first, then search the hub and write the raw
    and collapsed runs per set. Returns {set_name: collapsed run path}."""
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    encoded = {}
    for set_name, rows in query_sets.items():
        qids = [q for q, _ in rows]
        vecs = encoder.encode_queries([t for _, t in rows], batch_size=batch_size)
        encoded[set_name] = (qids, vecs)
    out: Dict[str, pathlib.Path] = {}
    for set_name, (qids, vecs) in encoded.items():
        vals, docids = hub_index.search(vecs, k, query_block=query_block, approx=approx)
        raw = outdir / f"{set_name}_raw.trec"
        base = outdir / f"{set_name}_base.trec"
        write_run(raw, qids, docids, vals, tag=tag, precision=6)
        collapse_run_max(raw, base, tag=tag)
        _write_set_meta(outdir, set_name, {
            "set": set_name,
            "num_queries": len(qids),
            "k": k,
            "index_count": hub_index.count,
            "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
            **(
                {"approx": str(approx), "certified_frac": float(hub_index.last_certified.mean())}
                if approx and hub_index.last_certified is not None else {}
            ),
        })
        out[set_name] = base
        log.info("bilingual run: %s -> %s", raw.name, base.name)
    return out


def validate_parallel_hub(hub_index: DenseFlatIndex) -> int:
    """Check that the hub is a PARALLEL two-language concatenation (equal
    counts, the same base docids in the same order) and return ``n_first``,
    the precondition of the on-device ``base = gid mod n_first`` collapse."""
    docids = hub_index.store.docids
    n = len(docids)
    if n % 2:
        raise ValueError(
            f"fused bilingual collapse needs a parallel 2-language hub; index has odd row count {n}"
        )
    n_first = n // 2
    if docids[:n_first] != docids[n_first:]:
        raise ValueError(
            "fused bilingual collapse needs mirrored base docids (language stores encoded over "
            "the same docid stream); the two halves of the hub differ"
        )
    return n_first


def run_bilingual_vector_mix_fused(
    hub_index: DenseFlatIndex,
    qids: Sequence[str],
    primary_vecs: np.ndarray,
    secondary_vecs: np.ndarray,
    alphas: Sequence[float],
    outdir,
    *,
    k: int = 500,
    qrels: Optional[Dict[str, Dict[str, int]]] = None,
    tag: str = "bilingual-onepass",
    approx=False,
    query_block: int = 256,
) -> Tuple[Dict[float, pathlib.Path], Optional[Dict[str, Dict[str, float]]]]:
    """The alpha sweep over a parallel hub on the device: mix -> raw search
    2k deep -> max-collapse to k base ids -> metrics when ``qrels`` are
    given. Writes :func:`run_bilingual_vector_mix`'s collapsed runs
    (``cm-alpha-<a>_base.trec`` + ``_meta.json``); no raw run reaches the
    host. Returns ({alpha: run path}, {alpha label: {metric: x100}} or None).

    ``approx=True`` searches through the sketch tier (each alpha's
    certificate rate lands in the meta); ``approx="guaranteed"`` escalates
    the uncertified (alpha, query) pairs to exact search, so the runs equal
    the exact sweep's."""
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    n_first = validate_parallel_hub(hub_index)
    base_docids = np.asarray(hub_index.store.docids[:n_first], dtype=object)
    rel_matrix, extra_zero = (None, 0) if qrels is None else qrels_rel_matrix(qids, qrels, base_docids)
    vals, ids, metrics, cert = sweep_index(
        hub_index, primary_vecs, secondary_vecs, alphas, k, approx=approx, rel_ids=rel_matrix,
        metric_extra_zero_queries=extra_zero, collapse_n_first=n_first, query_block=query_block,
    )
    out: Dict[float, pathlib.Path] = {}
    metric_out: Optional[Dict[str, Dict[str, float]]] = {} if metrics else None
    for ai, alpha in enumerate(alphas):
        label = format_alpha(alpha)
        base = outdir / f"cm-alpha-{label}_base.trec"
        gid = ids[ai]
        if (gid >= 0).all():
            write_run(base, qids, base_docids[gid], vals[ai], tag=tag, precision=6)
        else:
            # -1 slots (fewer distinct bases than k) are padding, not hits
            entries = []
            for qi, qid in enumerate(qids):
                for j in range(gid.shape[1]):
                    if gid[qi, j] < 0:
                        break
                    entries.append(RunEntry(qid, str(base_docids[gid[qi, j]]), j + 1,
                                            float(vals[ai, qi, j]), tag))
            write_run_entries(base, entries)
        meta = {
            "alpha": alpha,
            "num_queries": len(qids),
            "k": k,
            # the depth actually searched: the sweep clamps the 2k raw depth
            # to the count and the padded rows
            "k_raw": min(2 * k, hub_index.count, hub_index._rows_per_shard),
            "fused": True,
            "index_count": hub_index.count,
            "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        }
        if cert is not None:
            meta["approx"] = approx if isinstance(approx, str) else "fast"
            meta["certified_frac"] = round(float(cert[ai].mean()), 4)
        (outdir / f"cm-alpha-{label}_meta.json").write_text(json.dumps(meta, indent=2))
        out[alpha] = base
        if metrics:
            metric_out[label] = {name: round(float(v[ai]) * 100, 4) for name, v in metrics.items()}
    return out, metric_out


def run_bilingual_vector_mix(
    hub_index: DenseFlatIndex,
    qids: Sequence[str],
    primary_vecs: np.ndarray,
    secondary_vecs: np.ndarray,
    alphas: Sequence[float],
    outdir,
    *,
    k: int = 500,
    query_block: int = 1024,
    tag: str = "bilingual-onepass",
    approx=False,
) -> Dict[float, pathlib.Path]:
    """Alpha sweep over the hub; per alpha the raw run
    ``cm-alpha-<a>_raw.trec``, its collapse ``cm-alpha-<a>_base.trec`` and
    ``_meta.json``."""
    outdir = pathlib.Path(outdir)
    cert_by_alpha: Dict[float, float] = {}
    raw_runs = run_vector_mix_search(
        hub_index, qids, primary_vecs, secondary_vecs, alphas, outdir,
        k=k, query_block=query_block, tag=tag, approx=approx, cert_out=cert_by_alpha,
        run_prefix="cm-alpha-", write_meta=False,
        # the collapse needs 6 decimals: 4-decimal rounding makes ties that
        # reorder the collapsed run
        precision=6,
    )
    out: Dict[float, pathlib.Path] = {}
    for alpha, raw_path in raw_runs.items():
        label = format_alpha(alpha)
        raw = raw_path.rename(outdir / f"cm-alpha-{label}_raw.trec")
        base = outdir / f"cm-alpha-{label}_base.trec"
        collapse_run_max(raw, base, tag=tag)
        (outdir / f"cm-alpha-{label}_meta.json").write_text(json.dumps({
            "alpha": alpha,
            "num_queries": len(qids),
            "k": k,
            "index_count": hub_index.count,
            "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
            **(
                {"approx": str(approx), "certified_frac": cert_by_alpha[alpha]}
                if approx and alpha in cert_by_alpha else {}
            ),
        }, indent=2))
        out[alpha] = base
    return out
