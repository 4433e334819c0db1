"""Fused alpha sweep: mix -> search -> (collapse) -> metrics, on the device.

The index stays on its mesh for the whole sweep. For each alpha the mixed
queries are built on the first shard's device
(:func:`~codemix_dense_retrieval_torch.ops.mix.mix_and_renorm`), searched in
query blocks by the exact path (kernels 5 and ``cover_rescore``, A, 2 or 4)
or the sketch tier (kernel 7) on every shard and merged, collapsed for a
bilingual hub, and scored on the device; the host receives (A, B, k) ids
and one metric dict per alpha. Alphas run one after another, so one
block's phase-1 output per shard (bin maxima, or a (block, N) score store)
is the peak memory; the block is cut to the cards' free memory as the
unfused search cuts it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from codemix_dense_retrieval_torch.evals.device_metrics import topk_metrics
from codemix_dense_retrieval_torch.ops.collapse import collapse_topk_parallel_hub
from codemix_dense_retrieval_torch.ops.mix import mix_and_renorm
from codemix_dense_retrieval_torch.parallel.mesh import Mesh
from codemix_dense_retrieval_torch.parallel.sharded_search import (
    Shards,
    as_shards,
    search_blocks,
    sharded_topk_ip,
    sharded_topk_ip_sketch,
)
from codemix_dense_retrieval_torch.utils.logging import get_logger

log = get_logger("fused")

Sweep = Tuple[torch.Tensor, torch.Tensor, Optional[Dict[str, torch.Tensor]], Optional[torch.Tensor]]


def _f32(x, dev: torch.device) -> torch.Tensor:
    """Queries (numpy or tensor) as f32 on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(dev, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _resolve_depths(k, collapse_k_raw, collapse_n_first, docs, counts) -> Tuple[int, int]:
    """(k, k_raw) with the clamp of ``DenseFlatIndex.search`` (count and
    padded rows), shared by the sweep and its guaranteed escalation so both
    search the same depth."""
    k_raw = collapse_k_raw or (2 * k if collapse_n_first is not None else k)
    rows_per_shard = as_shards(docs)[0].shape[0]
    count = sum(int(c.sum()) for c in as_shards(counts))
    k_raw_eff = min(k_raw, count, rows_per_shard)
    if k_raw_eff < k_raw:
        log.warning(
            "fused sweep k_raw=%d clamped to %d (count=%d, rows_per_shard=%d)",
            k_raw, k_raw_eff, count, rows_per_shard,
        )
    return min(k, k_raw_eff), k_raw_eff


def _search_blocks(q, docs, counts, k_raw, query_block, search_kwargs, sketch=None, mesh=None):
    """Exact (or, with ``sketch``, sketch-tier) top-``k_raw`` of the f32
    queries ``q`` over the shards ``docs`` in blocks of ``query_block``
    rows, as ``DenseFlatIndex.search`` blocks them (:func:`search_blocks`).
    Returns (values, gids, certified or None)."""
    docs = as_shards(docs)
    search_kwargs = dict(search_kwargs)
    doc_scales = search_kwargs.pop("doc_scales", None)

    def run(blk):
        if sketch is not None:
            # the sketch tier takes the f32 queries and rounds them to the
            # index dtype itself, so the certificate covers the rounding
            sk, tails, proj, skw = sketch
            return sharded_topk_ip_sketch(
                blk, docs, counts, sk, tails, proj, k_raw, mesh=mesh,
                probe_bins=skw.get("probe_by_k", {}).get(k_raw, skw.get("probe_bins")),
                expand=float(skw.get("expand", 4.0)), doc_scales=doc_scales, **search_kwargs,
            )
        # an int8 index quantizes the f32 queries inside the search; casting
        # them straight to int8 here would truncate them
        if docs[0].dtype.is_floating_point:
            blk = blk.to(docs[0].dtype)
        return sharded_topk_ip(blk, docs, counts, k_raw, mesh=mesh, doc_scales=doc_scales, **search_kwargs)

    out = search_blocks(q, query_block, docs[0].shape[0], run,
                        [d.device for d in docs] if sketch is not None else docs, mesh)
    return out if sketch is not None else (*out, None)


def _finish(vals, gids, k, collapse_n_first):
    """The raw top-k_raw -> the k returned: collapsed for a hub, else cut."""
    if collapse_n_first is not None:
        return collapse_topk_parallel_hub(vals, gids, collapse_n_first, k_out=k)
    return vals[:, :k], gids[:, :k]


def fused_alpha_sweep(
    primary,  # (B, d) query embeddings, language A
    secondary,  # (B, d) language B, the same qid order
    alphas: Sequence[float],
    docs: Shards,
    counts: Shards,
    k: int,
    *,
    rel_ids=None,  # (B, R) int, -1 padded
    metric_cutoffs: Sequence[int] = (1, 3, 5, 10, 100),
    metric_extra_zero_queries: int = 0,
    search_kwargs: Optional[Dict] = None,
    collapse_n_first: Optional[int] = None,
    collapse_k_raw: Optional[int] = None,
    sketch: Optional[tuple] = None,
    query_block: int = 256,
    mesh: Optional[Mesh] = None,
) -> Sweep:
    """Returns (values (A, B, k), ids (A, B, k), metrics {name: (A,)} or
    None, certified (A, B) bool or None), all on the first shard's device.

    ``docs``/``counts``/``search_kwargs`` are an index's per-shard device
    rows, valid-row counts and search settings (``DenseFlatIndex._docs_dev``,
    ``_counts_dev``, ``search_kwargs``, which carries an int8 index's
    ``doc_scales``); ``mesh`` (``DenseFlatIndex.mesh``) is needed only for
    a multi-process mesh.

    ``sketch``: the index's armed sketch tier (``DenseFlatIndex._sketch``)
    routes every alpha's search through it (``--fused --approx fast``); the
    certificates mark the rows that are provably the exact sweep's.
    :func:`fused_alpha_sweep_guaranteed` adds the exact escalation.

    Bilingual parallel-hub mode: ``collapse_n_first`` (rows of the first
    language store) searches ``collapse_k_raw`` (default 2k) raw hits and
    max-collapses them on the device to k base ids; ``rel_ids`` then hold
    BASE row ids.

    **Exactness of the 2k default (two languages, distinct scores).** Let
    base b be the k-th collapsed base and s_b its max score. A raw row that
    outranks b's best row scores above s_b, so its base is one of the at most
    k-1 bases above b, and each base has at most 2 raw rows: b's best row
    sits at raw rank <= 2(k-1)+1 = 2k-1. And 2k raw rows span >= k distinct
    bases, so k collapsed outputs always exist. With TIED scores, (a) the
    base set at the boundary can differ from a full-depth collapse, as the
    host collapse over a raw run of bounded depth can, and (b) bases with
    equal collapsed scores are ordered by base id here, while
    ``collapse_run_max`` keeps first-appearance order. Collapsed scores are
    exact either way."""
    search_kwargs = dict(search_kwargs or {})
    if sketch is not None:
        from codemix_dense_retrieval_torch.ops.sketch import SKETCH_KERNEL_KWARGS

        search_kwargs = {
            kk: vv for kk, vv in search_kwargs.items() if kk in SKETCH_KERNEL_KWARGS + ("doc_scales",)
        }
    k, k_raw = _resolve_depths(k, collapse_k_raw, collapse_n_first, docs, counts)
    dev = as_shards(docs)[0].device
    p, s = _f32(primary, dev), _f32(secondary, dev)
    rel = None if rel_ids is None else torch.as_tensor(rel_ids, device=dev)
    vals_all, ids_all, certs, mets = [], [], [], []
    for alpha in alphas:
        q = mix_and_renorm(p, s, float(alpha))
        vals, gids, cert = _search_blocks(q, docs, counts, k_raw, query_block, search_kwargs, sketch, mesh)
        # a certified raw top-k_raw collapses to the exact collapsed top-k,
        # so the certificate survives the collapse
        vals, gids = _finish(vals, gids, k, collapse_n_first)
        vals_all.append(vals)
        ids_all.append(gids)
        certs.append(cert)
        if rel is not None:
            mets.append(topk_metrics(gids, rel, metric_cutoffs, metric_extra_zero_queries))
    metrics = {name: torch.stack([m[name] for m in mets]) for name in mets[0]} if mets else None
    return (
        torch.stack(vals_all),
        torch.stack(ids_all),
        metrics,
        torch.stack(certs) if sketch is not None else None,
    )


def fused_alpha_sweep_guaranteed(
    primary,
    secondary,
    alphas: Sequence[float],
    docs: Shards,
    counts: Shards,
    k: int,
    *,
    sketch: tuple,
    rel_ids=None,
    metric_cutoffs: Sequence[int] = (1, 3, 5, 10, 100),
    metric_extra_zero_queries: int = 0,
    search_kwargs: Optional[Dict] = None,
    collapse_n_first: Optional[int] = None,
    collapse_k_raw: Optional[int] = None,
    query_block: int = 256,
    mesh: Optional[Mesh] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[Dict[str, np.ndarray]], np.ndarray]:
    """``--fused --approx guaranteed``: the sketch sweep, then exact search of
    every uncertified (alpha, query) pair, so the output equals the exact
    fused sweep's (certified rows by the certificate, escalated rows by
    construction). Escalated queries are re-mixed by the same device
    function and searched exactly at the same clamped raw depth (in query
    blocks: the JAX package's pow2 bucket of their count serves XLA's
    compile cache and has no use here); the patched alphas' metrics are
    recomputed.

    Returns numpy (values (A, B, k), ids (A, B, k), metrics, certified
    (A, B)): the certificates BEFORE escalation, i.e. the share of the work
    that skipped the exact search."""
    vals, ids, metrics, cert = fused_alpha_sweep(
        primary, secondary, alphas, docs, counts, k,
        rel_ids=rel_ids, metric_cutoffs=metric_cutoffs,
        metric_extra_zero_queries=metric_extra_zero_queries, search_kwargs=search_kwargs,
        collapse_n_first=collapse_n_first, collapse_k_raw=collapse_k_raw, sketch=sketch,
        query_block=query_block, mesh=mesh,
    )
    cert_np = cert.cpu().numpy()
    vals_np, ids_np = vals.cpu().numpy(), ids.cpu().numpy()
    metrics_np = {name: v.cpu().numpy() for name, v in metrics.items()} if metrics else None
    if cert_np.all():
        return vals_np, ids_np, metrics_np, cert_np
    k_eff, k_raw = _resolve_depths(k, collapse_k_raw, collapse_n_first, docs, counts)
    dev = as_shards(docs)[0].device
    p, s = _f32(primary, dev), _f32(secondary, dev)
    for ai, alpha in enumerate(alphas):
        bad = np.flatnonzero(~cert_np[ai])
        if not len(bad):
            continue
        sel = torch.from_numpy(bad).to(dev)
        q = mix_and_renorm(p[sel], s[sel], float(alpha))
        e_vals, e_gids, _ = _search_blocks(q, docs, counts, k_raw, query_block, search_kwargs or {}, mesh=mesh)
        e_vals, e_gids = _finish(e_vals, e_gids, k_eff, collapse_n_first)
        vals_np[ai, bad] = e_vals.cpu().numpy()
        ids_np[ai, bad] = e_gids.cpu().numpy()
        if metrics_np is not None:
            patched = topk_metrics(
                torch.from_numpy(ids_np[ai]).to(dev), torch.as_tensor(rel_ids, device=dev),
                metric_cutoffs, metric_extra_zero_queries,
            )
            for name in metrics_np:
                metrics_np[name][ai] = float(patched[name])
    return vals_np, ids_np, metrics_np, cert_np


def sweep_index(
    index,
    primary,
    secondary,
    alphas: Sequence[float],
    k: int,
    *,
    approx=False,
    **kw,
) -> Tuple[np.ndarray, np.ndarray, Optional[Dict[str, np.ndarray]], Optional[np.ndarray]]:
    """The fused sweep over a card-resident ``DenseFlatIndex``, as numpy:
    exact, through its sketch tier (``approx=True``, armed with its defaults
    when it is not), or guaranteed (``approx="guaranteed"``: the sketch
    sweep plus exact escalation). ``kw`` passes to the sweep (``rel_ids``,
    ``metric_extra_zero_queries``, ``collapse_n_first``, ``query_block``)."""
    if approx == "adaptive":
        raise ValueError(
            "the fused sweep does not support approx='adaptive' (the probed-exact escalation "
            "is host-driven); use 'guaranteed' for exact output or the unfused path"
        )
    if index._docs_dev is None:
        index.to_device()
    sketch = None
    if approx:
        if index._sketch is None:
            index.enable_sketch()
        sketch = index._sketch
    args = (primary, secondary, list(alphas), index._docs_dev, index._counts_dev, k)
    kw = dict(kw, sketch=sketch, search_kwargs=index.search_kwargs, mesh=index.mesh)
    if approx == "guaranteed":
        return fused_alpha_sweep_guaranteed(*args, **kw)
    vals, ids, metrics, cert = fused_alpha_sweep(*args, **kw)
    return (
        vals.cpu().numpy(),
        ids.cpu().numpy(),
        {name: v.cpu().numpy() for name, v in metrics.items()} if metrics else None,
        None if cert is None else cert.cpu().numpy(),
    )
