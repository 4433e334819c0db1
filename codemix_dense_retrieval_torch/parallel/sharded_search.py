"""Exact search over a device-resident, row-padded index shard.

This slice runs one shard on one device. The shard's rows are padded to a
multiple of ``pad_multiple`` and masked by a device-resident valid-row count;
results carry global ids (local id + shard * rows_per_shard) and are merged
by the two-key order (score desc, global id asc), the merge that a
multi-device search reuses. An int8 shard carries its per-row scales as a
padded sidecar (:func:`shard_row_sidecar`) and searches over kernel 4.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from codemix_dense_retrieval_torch.ops import topk as topk_ops
from codemix_dense_retrieval_torch.ops.quant import int8_ip_scores, quantize_rows
from codemix_dense_retrieval_torch.utils import autotune
from codemix_dense_retrieval_torch.utils.logging import get_logger

# card bytes one query of a block takes per padded index row: its f32 score
# row and its bin maxima at the smallest bin (G = 8)
BLOCK_BYTES_PER_ROW = 4 + 4 / 8
# the share of the card's free memory one block's scores may take; the rest
# is the top-k tail's
BLOCK_MEMORY_SHARE = 0.75


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def fit_query_block(query_block: int, n_queries: int, rows_per_shard: int, device) -> int:
    """The query block a search over ``rows_per_shard`` padded rows runs:
    ``query_block`` (0: all ``n_queries`` in one block), on a CUDA card cut
    to the largest power of two whose score store and bin maxima
    (``BLOCK_BYTES_PER_ROW`` per query and row) fit in ``BLOCK_MEMORY_SHARE``
    of the free memory (the driver's free bytes plus what PyTorch's
    allocator holds unused). So the CLI's 1024-query default runs at the
    bilingual hub's size (17.7M x 1024 bf16 rows, 36.2 GB, on an 80 GB
    card: blocks of 256)."""
    device = torch.device(device)
    if device.type != "cuda":
        return query_block
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    fit = int(BLOCK_MEMORY_SHARE * free // (BLOCK_BYTES_PER_ROW * rows_per_shard))
    if min(query_block or n_queries, n_queries) <= fit:
        return query_block
    capped = 1 << max(0, fit.bit_length() - 1)
    get_logger("search").info(
        "query block %d cut to %d: %d padded rows, %.1f GB free on the card",
        query_block or n_queries, capped, rows_per_shard, free / 1e9,
    )
    return capped


def search_blocks(q: torch.Tensor, query_block: int, rows_per_shard: int, search) -> Tuple[torch.Tensor, ...]:
    """``search(block)`` over the query rows ``q`` in blocks of
    ``query_block`` rows (0 = one block), cut to the card by
    :func:`fit_query_block`. A ragged tail block is zero-padded to the block
    size, so every block has one shape, and its rows are sliced off. Returns
    each of ``search``'s outputs concatenated over the blocks, cut to
    ``len(q)`` rows."""
    n = len(q)
    query_block = fit_query_block(query_block, n, rows_per_shard, q.device)
    if query_block and n > query_block and n % query_block:
        q = torch.cat([q, q.new_zeros((query_block - n % query_block, q.shape[1]))])
    outs = [search(blk) for blk in (q.split(query_block) if query_block else [q])]
    return tuple(torch.cat(parts)[:n] for parts in zip(*outs))


def shard_rows(
    store,
    device: torch.device,
    *,
    pad_multiple: int = 1024,
    chunk_rows: int = 262_144,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Place a shard store's (N, d) rows on ``device`` in the store's dtype,
    zero-padded to ``rows_per_shard`` (a multiple of ``pad_multiple``),
    copying ``chunk_rows`` rows at a time so no second host copy of the
    index exists. Returns (rows (rows_per_shard, d), valid-row count (1,)
    int32 on device, rows_per_shard)."""
    n, d = store.count, store.dim
    rows_per_shard = _ceil_to(max(1, n), pad_multiple)
    docs = torch.empty((rows_per_shard, d), dtype=store.torch_dtype, device=device)
    for start in range(0, n, chunk_rows):
        stop = min(start + chunk_rows, n)
        docs[start:stop].copy_(store.rows(start, stop))
    docs[n:].zero_()
    counts = torch.tensor([n], dtype=torch.int32, device=device)
    return docs, counts, rows_per_shard


def shard_row_sidecar(
    values: np.ndarray, device: torch.device, rows_per_shard: int
) -> torch.Tensor:
    """A per-row (N,) sidecar (int8 scales) on ``device`` with the padded
    layout of :func:`shard_rows` (zeros past N)."""
    src = torch.from_numpy(np.ascontiguousarray(values))
    out = torch.zeros(rows_per_shard, dtype=src.dtype, device=device)
    out[: len(src)].copy_(src)
    return out


def _merge_two_key(vals: torch.Tensor, gids: torch.Tensor, k: int):
    """Select the top k of (B, m) candidates by (score desc, gid asc)."""
    by_id = torch.argsort(gids, dim=1, stable=True)
    vals = torch.gather(vals, 1, by_id)
    gids = torch.gather(gids, 1, by_id)
    by_score = torch.argsort(vals, dim=1, descending=True, stable=True)[:, :k]
    return torch.gather(vals, 1, by_score), torch.gather(gids, 1, by_score)


METHODS = ("auto", "full", "bins_xla", "bins_pallas", "bins_two_level")


def _resolve_tile_b(tile_b: Optional[int], k: int, default: int) -> int:
    """``tile_b`` None -> the tuned store's per-depth entry when it holds
    one (``topk.tile_b.k<k>`` or ``topk.tile_b``), else ``default``, so a
    card without a store keeps the path's own default."""
    if tile_b is not None:
        return int(tile_b)
    store = autotune.load_tuned()
    if f"topk.tile_b.k{k}" not in store and "topk.tile_b" not in store:
        return default
    return topk_ops._tuned_tile_b(k, default=default)


def sharded_topk_ip(
    queries: torch.Tensor,
    docs: torch.Tensor,
    counts: torch.Tensor,
    k: int,
    *,
    bin_size: Optional[int] = None,
    method: str = "auto",
    tile_n: int = 1024,
    tile_b: Optional[int] = None,
    doc_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a padded shard ``docs`` whose first ``counts[0]``
    rows are valid. ``queries`` must already be in the index dtype, except
    over an int8 shard: there they stay float and are quantized per row on
    the device, and ``doc_scales`` (the shard's per-row f32 scales, padded
    like the rows) is required. Returns (values (B, k) f32, global ids
    (B, k) int64); ties go to the lower id.

    Routing: shards of 262,144 rows or more take the two-level cover
    (kernel A, or kernel 4 for int8, bin-major), smaller ones the
    single-level cover (the same kernels, transposed); ``method`` may also
    name ``full`` or ``bins_xla``, which score with the plain versions."""
    shard_id = 0
    rows_per_shard = docs.shape[0]
    if k > rows_per_shard:
        raise ValueError(
            f"k={k} > rows_per_shard={rows_per_shard}; lower k or use fewer shards"
        )
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")
    int8_mode = docs.dtype == torch.int8
    if int8_mode and doc_scales is None:
        raise ValueError("int8 index requires doc_scales")
    if method == "auto":
        method = "bins_two_level" if rows_per_shard >= topk_ops.TWO_LEVEL_MIN_ROWS else "bins_pallas"
    if bin_size is None:
        bin_size = (
            topk_ops._auto_bin_size_two_level(k)
            if method == "bins_two_level" else topk_ops._auto_bin_size(k)
        )
    if method == "bins_two_level":
        tile_b = _resolve_tile_b(tile_b, k, 256)
    elif tile_b is None:
        # tuned tile_b entries are measured on the two-level cover only
        tile_b = 256
    n_valid = counts[:1]
    if int8_mode and method in ("bins_pallas", "bins_two_level"):
        vals, idx = topk_ops.topk_ip_bins_int8(
            queries, docs, doc_scales, k, bin_size=bin_size, tile_b=tile_b, tile_n=tile_n,
            n_valid=n_valid, two_level=(method == "bins_two_level"),
        )
    elif method == "full" or int8_mode:
        if int8_mode:
            q_vals, q_scales = quantize_rows(queries)
            scores = int8_ip_scores(q_vals, q_scales, docs, doc_scales)
        else:
            scores = queries.to(torch.float32) @ docs.to(torch.float32).T
        col = torch.arange(rows_per_shard, device=docs.device)
        scores = torch.where(col[None, :] < n_valid, scores, topk_ops.NEG_INF)
        if method == "bins_xla":
            # pad the tail UP to a bin multiple with NEG_INF (never
            # selectable): truncating would make tail rows unselectable
            n_pad_b = -(-scores.shape[1] // bin_size) * bin_size
            if n_pad_b != scores.shape[1]:
                scores = torch.nn.functional.pad(
                    scores, (0, n_pad_b - scores.shape[1]), value=topk_ops.NEG_INF
                )
            bin_max = scores.view(scores.shape[0], -1, bin_size).amax(dim=2)
            vals, idx = topk_ops._topk_from_bins(scores, bin_max, k, bin_size)
        else:
            vals, idx = topk_ops._stable_topk(scores, k)
    elif method == "bins_two_level":
        vals, idx = topk_ops.topk_ip_bins_two_level(
            queries, docs, k, bin_size=bin_size, tile_b=tile_b, tile_n=tile_n,
            n_valid=n_valid,
        )
    else:
        vals, idx = topk_ops.topk_ip_bins(
            queries, docs, k, bin_size=bin_size, use_kernel=(method == "bins_pallas"),
            tile_b=tile_b, tile_n=tile_n, n_valid=n_valid,
        )
    gids = idx + shard_id * rows_per_shard
    return _merge_two_key(vals, gids, k)


def sharded_topk_ip_adaptive(
    queries: torch.Tensor,
    docs: torch.Tensor,
    counts: torch.Tensor,
    k: int,
    *,
    probe_bins: Optional[int] = None,
    expand: float = 2.0,
    bin_size: int = 8,
    super_size: Optional[int] = None,
    tile_n: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Always-exact adaptive top-k over a padded shard: the probed two-level
    cover (kernel A bin-major at every shard size,
    :func:`~codemix_dense_retrieval_torch.ops.topk.topk_ip_bins_two_level_probed`)
    certifies each query against the true unselected-bin maxima, and only
    the uncertified queries escalate:

    - at most B/2 escalated: the full selection tail on the retained scores
      (:func:`~codemix_dense_retrieval_torch.ops.topk.topk_full_tail_bm`),
      with no second kernel-A pass;
    - more than B/2: the retained scores are freed first, then
      :func:`sharded_topk_ip` runs the escalated queries in the caller's
      query dtype (one score store at a time on the card).

    The certificate composes over shards: the merged k-th value against the
    largest of the shards' unselected bounds. The JAX package pads the
    escalated set to a power of two for XLA's compile cache; eager PyTorch
    has no such cache, so the port does not. Returns (values (B, k) f32,
    global ids (B, k) int64, stats ``certified_frac``, ``probe_bins`` and,
    when a query escalated, ``escalated``); results equal
    :func:`sharded_topk_ip`'s for every query. The probed cover scores its
    whole batch in one launch (the escalation reads that score store), so
    there is no ``tile_b``."""
    from codemix_dense_retrieval_torch.ops.sketch import _default_probe_bins

    shard_id = 0
    rows_per_shard = docs.shape[0]
    if k > rows_per_shard:
        raise ValueError(
            f"k={k} > rows_per_shard={rows_per_shard}; lower k or use fewer shards"
        )
    if docs.dtype == torch.int8:
        raise NotImplementedError(
            "adaptive probed-exact search supports bf16/f32 indexes; "
            "int8 indexes use the fixed cover (sharded_topk_ip) or the "
            "int8 sketch tier"
        )
    if super_size is None:
        super_size = topk_ops._auto_super_size(k)
    nb_local = rows_per_shard // bin_size
    if probe_bins is None:
        probe_bins = _default_probe_bins(k, bin_size, nb_local, expand)
    probe_bins = max(min(probe_bins, nb_local), -(-k // bin_size))
    vals, idx, _, unsel, scores_bm, binmax_bm = topk_ops.topk_ip_bins_two_level_probed(
        queries, docs, k, probe_bins=probe_bins, bin_size=bin_size, super_size=super_size,
        tile_n=tile_n, n_valid=counts[:1], keep_scores=True,
    )
    vals, gids = _merge_two_key(vals, idx + shard_id * rows_per_shard, k)
    cert = (vals[:, k - 1] > unsel).cpu().numpy()
    b = len(cert)
    stats = {"certified_frac": float(cert.mean()), "probe_bins": probe_bins}
    if cert.all():
        return vals, gids, stats
    bad = np.flatnonzero(~cert)
    qsel = torch.from_numpy(bad).to(queries.device)
    if len(bad) <= b // 2:
        ev, eidx = topk_ops.topk_full_tail_bm(scores_bm, binmax_bm, qsel, k, bin_size, super_size)
        del scores_bm, binmax_bm
        ev, eg = _merge_two_key(ev, eidx + shard_id * rows_per_shard, k)
    else:
        del scores_bm, binmax_bm  # freed BEFORE the exact path's score store
        ev, eg = sharded_topk_ip(queries.index_select(0, qsel), docs, counts, k, tile_n=tile_n)
    vals[qsel] = ev
    gids[qsel] = eg
    stats["escalated"] = int(len(bad))
    return vals, gids, stats


def sharded_topk_ip_sketch(
    queries: torch.Tensor,
    docs: torch.Tensor,
    counts: torch.Tensor,
    sketch: torch.Tensor,
    tails: torch.Tensor,
    proj: torch.Tensor,
    k: int,
    *,
    probe_bins: Optional[int] = None,
    expand: float = 4.0,
    bin_size: Optional[int] = None,
    super_size: Optional[int] = None,
    tile_n: int = 1024,
    tile_b: Optional[int] = None,
    doc_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Approximate top-k over a padded shard with per-query exactness
    certificates (:mod:`~codemix_dense_retrieval_torch.ops.sketch`).
    ``sketch``/``tails`` come from ``sketch_rows`` over the padded rows (for
    an int8 shard: ``sketch_rows_int8``, and ``doc_scales`` is required; the
    certificates then prove parity with the int8 exact path). Returns
    (values (B, k), global ids (B, k), certified (B,) bool). A query's
    certificate over several shards is the AND of its per-shard ones."""
    from codemix_dense_retrieval_torch.ops import sketch as sketch_ops

    bin_size = bin_size or sketch_ops.DEFAULT_BIN_SIZE
    super_size = super_size or sketch_ops.DEFAULT_SUPER_SIZE
    shard_id = 0
    rows_per_shard = docs.shape[0]
    if k > rows_per_shard:
        raise ValueError(
            f"k={k} > rows_per_shard={rows_per_shard}; lower k or use fewer shards"
        )
    if probe_bins is None:
        probe_bins = sketch_ops._default_probe_bins(
            k, bin_size, rows_per_shard // bin_size, expand
        )
    tile_b = 512 if tile_b is None else tile_b
    common = dict(probe_bins=probe_bins, bin_size=bin_size, super_size=super_size,
                  tile_b=tile_b, tile_n=tile_n, n_valid=counts[:1])
    if docs.dtype == torch.int8:
        if doc_scales is None:
            raise ValueError("int8 index requires doc_scales")
        vals, idx, cert = sketch_ops.topk_ip_sketch_int8(
            queries, docs, doc_scales, sketch, tails, proj, k, **common
        )
    else:
        vals, idx, cert = sketch_ops.topk_ip_sketch(
            queries, docs, sketch, tails, proj, k, **common
        )
    vals, gids = _merge_two_key(vals, idx + shard_id * rows_per_shard, k)
    return vals, gids, cert
