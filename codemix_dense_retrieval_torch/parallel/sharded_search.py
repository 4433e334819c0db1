"""Exact search over a row-sharded, device-resident index.

The index's rows are split over the mesh's ``shard`` axis in the JAX
package's layout: ``rows_per_shard = ceil_to(ceil(N / S), pad_multiple)``
rows per shard, shard s holding global rows ``[s * rps, s * rps + count_s)``
with the rest zero-padded and masked by the shard's device-resident
valid-row count. Each shard is one tensor on its mesh device (a mesh may
put several shards on one device), with an int8 shard's per-row scales as a
padded sidecar (:func:`shard_row_sidecar`).

A search launches every shard's search on its own device before it reads
any result, maps each shard's local ids to global ones
(``idx + s * rps``), gathers the S (B, k) candidate lists onto the mesh's
first device and merges them by (score desc, global id asc), the order of
the JAX package's two-key ``lax.sort``. Across processes
(``parallel/multihost.py``) the merge adds one all-gather of the (B, k)
payload. No score matrix and no index row crosses a device.

Which route one shard takes (its method, bin size, queries per launch and
the phase-1 memory that sizes a query block) is :mod:`~codemix_dense_retrieval_torch.ops.topk`'s
(``shard_topk``, ``block_bytes_per_row``) and, for the sketch tier,
:mod:`~codemix_dense_retrieval_torch.ops.sketch`'s (``shard_topk_sketch``);
this module places the shards, launches them and merges their results.

Shards and their sidecars are passed as lists of per-shard tensors; a bare
tensor is one shard.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from codemix_dense_retrieval_torch.ops import topk as topk_ops
from codemix_dense_retrieval_torch.parallel.mesh import Mesh, as_mesh, gather_to
from codemix_dense_retrieval_torch.utils import timing
from codemix_dense_retrieval_torch.utils.logging import get_logger

Shards = Union[torch.Tensor, Sequence[torch.Tensor]]

# the share of the card's free memory one block's scores may take; the rest
# is the top-k tail's
BLOCK_MEMORY_SHARE = 0.75


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def as_shards(x: Optional[Shards]) -> Optional[List[torch.Tensor]]:
    """Per-shard tensors as a list; a bare tensor is one shard."""
    if x is None or isinstance(x, list):
        return x
    return [x] if isinstance(x, torch.Tensor) else list(x)


def fit_query_block(
    query_block: int, n_queries: int, rows_per_shard: int,
    devices: Union[torch.device, str, torch.Tensor, Sequence[Union[torch.device, str, torch.Tensor]]],
) -> int:
    """The query block a search over shards of ``rows_per_shard`` padded rows
    on ``devices`` (a device, each shard's device, or the shards' tensors)
    runs: ``query_block`` (0: all ``n_queries`` in one block), on CUDA cards
    cut to the largest power of two whose phase-1 outputs (the score stores
    and bin maxima,
    :func:`~codemix_dense_retrieval_torch.ops.topk.block_bytes_per_row` per
    query and row, for every shard on the card, since all shards are
    launched before any is read)
    fit in ``BLOCK_MEMORY_SHARE`` of each card's free memory (the driver's
    free bytes plus what PyTorch's allocator holds unused). A bare device
    counts the score store. So the CLI's 1024-query default runs at the
    bilingual hub's size (17.7M x 1024 bf16 rows, 36.2 GB, on an 80 GB
    card) in blocks of 256 where the search stores its scores, and uncut
    where it writes bin maxima alone. The free-memory reads are the span
    ``search.fit_block``."""
    if not isinstance(devices, (list, tuple)):
        devices = [devices]
    need: dict = {}  # device -> (shards, bytes per query and padded row)
    for d in devices:
        device = torch.device(d) if isinstance(d, (torch.device, str)) else d.device
        count, per_row = need.get(device, (0, 0.0))
        need[device] = (count + 1, per_row + topk_ops.block_bytes_per_row(d))
    fit, short = None, None
    with timing.span("search.fit_block"):
        for device, (count, per_row) in need.items():
            if device.type != "cuda":
                continue
            free, _ = torch.cuda.mem_get_info(device)
            free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
            f = int(BLOCK_MEMORY_SHARE * free // (per_row * rows_per_shard))
            if fit is None or f < fit:
                fit, short = f, (device, count, free)
    if fit is None or min(query_block or n_queries, n_queries) <= fit:
        return query_block
    capped = 1 << max(0, fit.bit_length() - 1)
    get_logger("search").info(
        "query block %d cut to %d: %d shard(s) of %d padded rows, %.1f GB free on %s",
        query_block or n_queries, capped, short[1], rows_per_shard, short[2] / 1e9, short[0],
    )
    return capped


def search_blocks(
    q: torch.Tensor, query_block: int, rows_per_shard: int, search,
    devices: Optional[Sequence[Union[torch.device, torch.Tensor]]] = None, mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, ...]:
    """``search(block)`` over the query rows ``q`` in blocks of
    ``query_block`` rows (0 = one block), cut to the cards of ``devices``
    (each shard's device or tensor; default ``q``'s device) by
    :func:`fit_query_block`; over a multi-process ``mesh`` every process
    takes the smallest cut, so all run the same blocks (and the same
    collectives). A ragged tail block is zero-padded to the block size, so
    every block has one shape, and its rows are sliced off. Returns each of ``search``'s outputs concatenated
    over the blocks, cut to ``len(q)`` rows. While tracing each block is
    the span ``search.block``, counted with the queries under
    ``search.blocks`` and ``search.queries``."""
    n = len(q)
    query_block = fit_query_block(query_block, n, rows_per_shard, devices or q.device)
    if _multi_process(mesh):
        from codemix_dense_retrieval_torch.parallel.multihost import all_reduce_max

        agreed = -all_reduce_max(torch.tensor([-(query_block or n)], device=q.device), mesh)
        query_block = 0 if int(agreed[0]) >= n else int(agreed[0])
    if query_block and n > query_block and n % query_block:
        q = torch.cat([q, q.new_zeros((query_block - n % query_block, q.shape[1]))])
    outs = []
    for blk in q.split(query_block) if query_block else [q]:
        with timing.span("search.block"):
            outs.append(search(blk))
    timing.count("search.blocks", len(outs))
    timing.count("search.queries", n)
    return tuple(torch.cat(parts)[:n] for parts in zip(*outs))


def shard_layout(n: int, shards: int, pad_multiple: int) -> Tuple[int, np.ndarray]:
    """(rows_per_shard, per-shard valid counts (S,)) of ``n`` rows over
    ``shards`` shards: ``ceil_to(ceil(n / S), pad_multiple)`` rows each,
    filled in shard order (the JAX package's ``shard_rows``)."""
    rows_per_shard = _ceil_to(max(1, -(-n // shards)), pad_multiple)
    counts = np.clip(n - rows_per_shard * np.arange(shards), 0, rows_per_shard).astype(np.int64)
    return rows_per_shard, counts


def place_rows(
    read: Callable[[int, int], torch.Tensor],
    n: int,
    dim: int,
    dtype: torch.dtype,
    mesh: Mesh,
    *,
    pad_multiple: int = 1024,
    chunk_rows: int = 262_144,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], int]:
    """Place ``n`` global rows of width ``dim`` on this process's shards of
    ``mesh`` (:func:`shard_layout`), ``read(start, stop)`` giving the rows
    ``[start, stop)`` as a host tensor; each shard copies ``chunk_rows`` rows
    at a time, so no second host copy of the index exists, and zeroes its
    pad. Returns (rows per local shard (rows_per_shard, d), valid-row count
    per local shard ((1,) int32 on its device), rows_per_shard)."""
    rows_per_shard, counts = shard_layout(n, mesh.shape["shard"], pad_multiple)
    docs, valid = [], []
    for local, device in enumerate(mesh.shard_devices()):
        g = mesh.first_shard + local
        c = int(counts[g])
        rows = torch.empty((rows_per_shard, dim), dtype=dtype, device=device)
        for lo in range(0, c, chunk_rows):
            hi = min(lo + chunk_rows, c)
            rows[lo:hi].copy_(read(g * rows_per_shard + lo, g * rows_per_shard + hi))
        rows[c:].zero_()
        docs.append(rows)
        valid.append(torch.tensor([c], dtype=torch.int32, device=device))
    return docs, valid, rows_per_shard


def shard_rows(
    store,
    mesh: Union[Mesh, torch.device, str],
    *,
    pad_multiple: int = 1024,
    chunk_rows: int = 262_144,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], int]:
    """Place a shard store's (N, d) rows on the shards of ``mesh`` (a device:
    one shard on it) in the store's dtype, in the layout of
    :func:`shard_layout` (:func:`place_rows`). Returns (rows per shard,
    valid-row count per shard, rows_per_shard)."""
    return place_rows(
        store.rows, store.count, store.dim, store.torch_dtype, as_mesh(mesh),
        pad_multiple=pad_multiple, chunk_rows=chunk_rows,
    )


def shard_row_sidecar(
    values: np.ndarray, mesh: Union[Mesh, torch.device, str], rows_per_shard: int
) -> List[torch.Tensor]:
    """A per-row (N,) sidecar (int8 scales) on the shards of ``mesh`` with
    the padded layout of :func:`shard_rows` (zeros past each shard's rows)."""
    mesh = as_mesh(mesh)
    src = torch.from_numpy(np.ascontiguousarray(values))
    out = []
    for local, device in enumerate(mesh.shard_devices()):
        lo = (mesh.first_shard + local) * rows_per_shard
        part = src[lo : lo + rows_per_shard]
        t = torch.zeros(rows_per_shard, dtype=src.dtype, device=device)
        t[: len(part)].copy_(part)
        out.append(t)
    return out


def _merge_two_key(vals: torch.Tensor, gids: torch.Tensor, k: int):
    """Select the top k of (B, m) candidates by (score desc, gid asc)."""
    by_id = torch.argsort(gids, dim=1, stable=True)
    vals = torch.gather(vals, 1, by_id)
    gids = torch.gather(gids, 1, by_id)
    by_score = torch.argsort(vals, dim=1, descending=True, stable=True)[:, :k]
    return torch.gather(vals, 1, by_score), torch.gather(gids, 1, by_score)


def _multi_process(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.process_count > 1


def merge_shards(
    vals: Sequence[torch.Tensor], gids: Sequence[torch.Tensor], k: int, mesh: Optional[Mesh] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global top k of the local shards' (B, k) candidates: gathered
    onto the first shard's device and merged by (score desc, gid asc); over
    a multi-process ``mesh`` the local (B, k) result is then all-gathered
    across processes and merged again, so every process holds the global
    result."""
    dev = vals[0].device
    out = _merge_two_key(gather_to(vals, dev), gather_to(gids, dev), k)
    if _multi_process(mesh):
        from codemix_dense_retrieval_torch.parallel.multihost import all_gather_candidates

        out = _merge_two_key(*all_gather_candidates(*out, mesh), k)
    return out


def _global_max(parts: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> torch.Tensor:
    """Elementwise max of per-shard (B,) tensors over every shard of the
    mesh (all processes), on the first shard's device."""
    out = gather_to([p[:, None] for p in parts], parts[0].device).amax(dim=1)
    if _multi_process(mesh):
        from codemix_dense_retrieval_torch.parallel.multihost import all_reduce_max

        out = all_reduce_max(out, mesh)
    return out


def _global_all(parts: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> torch.Tensor:
    """Elementwise AND of per-shard (B,) bool tensors over every shard of
    the mesh (all processes), on the first shard's device."""
    return _global_max([(~p).to(torch.uint8) for p in parts], mesh) == 0


def _shard_offsets(docs: List[torch.Tensor], mesh: Optional[Mesh]) -> List[int]:
    """The global id of each local shard's first row."""
    first = mesh.first_shard if mesh is not None else 0
    rows_per_shard = docs[0].shape[0]
    return [(first + s) * rows_per_shard for s in range(len(docs))]


def _check_k(k: int, rows_per_shard: int) -> None:
    if k > rows_per_shard:
        raise ValueError(
            f"k={k} > rows_per_shard={rows_per_shard}; lower k or use fewer shards"
        )


def sharded_topk_ip(
    queries: torch.Tensor,
    docs: Shards,
    counts: Shards,
    k: int,
    *,
    mesh: Optional[Mesh] = None,
    bin_size: Optional[int] = None,
    method: str = "auto",
    tile_n: int = 1024,
    tile_b: Optional[int] = None,
    doc_scales: Optional[Shards] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over padded shards ``docs`` (:func:`shard_rows`), shard s
    valid in its first ``counts[s][0]`` rows. ``queries`` must already be in
    the index dtype, except over an int8 index: there they stay float and
    are quantized per row on each shard's device, and ``doc_scales`` (the
    per-row f32 scales, padded like the rows) is required. ``mesh`` is
    needed only for a multi-process mesh (the shards' global offsets and
    the cross-process merge). Returns (values (B, k) f32, global ids (B, k)
    int64) on the first shard's device; ties go to the lower id.

    Each shard runs :func:`~codemix_dense_retrieval_torch.ops.topk.shard_topk`,
    which takes ``method``, ``bin_size``, ``tile_b``, ``tile_n`` and its
    ``doc_scales`` and decides the route."""
    docs, counts, doc_scales = as_shards(docs), as_shards(counts), as_shards(doc_scales)
    _check_k(k, docs[0].shape[0])
    # every shard is launched before any result is read
    vals, gids = [], []
    for s, (d, off) in enumerate(zip(docs, _shard_offsets(docs, mesh))):
        v, idx = topk_ops.shard_topk(
            queries.to(d.device, non_blocking=True), d, k, n_valid=counts[s][:1],
            doc_scales=None if doc_scales is None else doc_scales[s], method=method,
            bin_size=bin_size, tile_b=tile_b, tile_n=tile_n,
        )
        vals.append(v)
        gids.append(idx + off)
    return merge_shards(vals, gids, k, mesh)


def sharded_topk_ip_adaptive(
    queries: torch.Tensor,
    docs: Shards,
    counts: Shards,
    k: int,
    *,
    mesh: Optional[Mesh] = None,
    probe_bins: Optional[int] = None,
    expand: float = 2.0,
    bin_size: int = 8,
    super_size: Optional[int] = None,
    tile_n: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Always-exact adaptive top-k over padded shards: each shard runs the
    probed two-level cover (kernel A bin-major at every shard size,
    :func:`~codemix_dense_retrieval_torch.ops.topk.topk_ip_bins_two_level_probed`)
    and keeps its phase-1 scores on its own device; a query is certified
    when the merged k-th value beats the largest of the shards' true
    unselected-bin maxima, and only the uncertified queries escalate:

    - at most B/2 escalated: the full selection tail on each shard's
      retained scores
      (:func:`~codemix_dense_retrieval_torch.ops.topk.topk_full_tail_bm`),
      merged as the main pass is, with no second kernel-A pass;
    - more than B/2: the retained scores are freed first, then
      :func:`sharded_topk_ip` runs the escalated queries in the caller's
      query dtype (one score store per shard at a time).

    The JAX package pads the escalated set to a power of two for XLA's
    compile cache; eager PyTorch has no such cache, so the port does not.
    Returns (values (B, k) f32, global ids (B, k) int64, stats
    ``certified_frac``, ``probe_bins`` and, when a query escalated,
    ``escalated``); results equal :func:`sharded_topk_ip`'s for every query.
    The probed cover scores its whole batch in one launch per shard (the
    escalation reads that score store), so there is no ``tile_b``."""
    from codemix_dense_retrieval_torch.ops.sketch import _default_probe_bins

    docs, counts = as_shards(docs), as_shards(counts)
    rows_per_shard = docs[0].shape[0]
    _check_k(k, rows_per_shard)
    if docs[0].dtype == torch.int8:
        raise NotImplementedError(
            "adaptive probed-exact search supports bf16/f32 indexes; "
            "int8 indexes use the fixed cover (sharded_topk_ip) or the "
            "int8 sketch tier"
        )
    nb_local = rows_per_shard // bin_size
    if probe_bins is None:
        probe_bins = _default_probe_bins(k, bin_size, nb_local, expand)
    probe_bins = max(min(probe_bins, nb_local), -(-k // bin_size))
    offsets = _shard_offsets(docs, mesh)
    vals, gids, unsel, kept = [], [], [], []
    for s, d in enumerate(docs):
        v, idx, _, un, scores_bm, binmax_bm = topk_ops.topk_ip_bins_two_level_probed(
            queries.to(d.device, non_blocking=True), d, k, probe_bins=probe_bins,
            bin_size=bin_size, super_size=super_size, tile_n=tile_n, n_valid=counts[s][:1],
            keep_scores=True,
        )
        vals.append(v)
        gids.append(idx + offsets[s])
        unsel.append(un)
        kept.append((scores_bm, binmax_bm))
    vals, gids = merge_shards(vals, gids, k, mesh)
    cert = (vals[:, k - 1] > _global_max(unsel, mesh)).cpu().numpy()
    b = len(cert)
    stats = {"certified_frac": float(cert.mean()), "probe_bins": probe_bins}
    if cert.all():
        return vals, gids, stats
    bad = np.flatnonzero(~cert)
    if len(bad) <= b // 2:
        ev, eg = [], []
        for s, (scores_bm, binmax_bm) in enumerate(kept):
            qsel = torch.from_numpy(bad).to(scores_bm.device)
            v, idx = topk_ops.topk_full_tail_bm(scores_bm, binmax_bm, qsel, k, bin_size, super_size)
            ev.append(v)
            eg.append(idx + offsets[s])
        del kept, scores_bm, binmax_bm
        ev, eg = merge_shards(ev, eg, k, mesh)
    else:
        del kept  # freed BEFORE the exact path's score stores
        qsel = torch.from_numpy(bad).to(queries.device)
        ev, eg = sharded_topk_ip(queries.index_select(0, qsel), docs, counts, k, mesh=mesh, tile_n=tile_n)
    sel = torch.from_numpy(bad).to(vals.device)
    vals[sel] = ev
    gids[sel] = eg
    stats["escalated"] = int(len(bad))
    return vals, gids, stats


def sharded_topk_ip_sketch(
    queries: torch.Tensor,
    docs: Shards,
    counts: Shards,
    sketch: Shards,
    tails: Shards,
    proj: torch.Tensor,
    k: int,
    *,
    mesh: Optional[Mesh] = None,
    probe_bins: Optional[int] = None,
    expand: float = 4.0,
    bin_size: Optional[int] = None,
    super_size: Optional[int] = None,
    tile_n: int = 1024,
    tile_b: Optional[int] = None,
    doc_scales: Optional[Shards] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Approximate top-k over padded shards with per-query exactness
    certificates (:mod:`~codemix_dense_retrieval_torch.ops.sketch`).
    ``sketch``/``tails`` come from ``sketch_rows`` over each shard's padded
    rows (for an int8 index: ``sketch_rows_int8``, and ``doc_scales`` is
    required; the certificates then prove parity with the int8 exact path).
    Returns (values (B, k), global ids (B, k), certified (B,) bool). A
    query's certificate is the AND of its per-shard ones: every shard's
    local top k being exact makes the merged top k exact."""
    from codemix_dense_retrieval_torch.ops.sketch import shard_topk_sketch

    docs, counts = as_shards(docs), as_shards(counts)
    sketch, tails, doc_scales = as_shards(sketch), as_shards(tails), as_shards(doc_scales)
    _check_k(k, docs[0].shape[0])
    vals, gids, certs = [], [], []
    for s, (d, off) in enumerate(zip(docs, _shard_offsets(docs, mesh))):
        v, idx, cert = shard_topk_sketch(
            queries.to(d.device, non_blocking=True), d, sketch[s], tails[s], proj, k,
            n_valid=counts[s][:1], doc_scales=None if doc_scales is None else doc_scales[s],
            probe_bins=probe_bins, expand=expand, bin_size=bin_size, super_size=super_size,
            tile_b=tile_b, tile_n=tile_n,
        )
        vals.append(v)
        gids.append(idx + off)
        certs.append(cert)
    vals, gids = merge_shards(vals, gids, k, mesh)
    return vals, gids, _global_all(certs, mesh)
