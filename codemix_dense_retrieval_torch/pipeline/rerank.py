"""Two-stage multi-vector search: dense recall -> MaxSim rerank.

1. dense stage: the exact (or sketch-tier) top-``k_dense`` over the flat
   index;
2. gather: the candidates' token blocks, either row-gathered from a
   card-resident copy of the token store (when it fits the budget) or
   gathered on the host from the memory-mapped
   :class:`~codemix_dense_retrieval_torch.io.token_shards.TokenShardStore`
   (touching only the candidates' pages) on a prefetch thread, the unique
   blocks of a query block only when that ships fewer bytes;
3. rerank: int8 blocks are dequantized to bf16 on the device and scored by
   kernel 6 (:func:`~codemix_dense_retrieval_torch.ops.maxsim.maxsim_rerank`);
   ties go to the lower row id, as in the dense stage.

A card-resident searcher also mutates online (:meth:`TwoStageSearcher.add`,
:meth:`~TwoStageSearcher.remove`, :meth:`~TwoStageSearcher.save`): the token
blocks follow the dense index's row positions.
"""

from __future__ import annotations

import itertools
import json
import pathlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex, swap_sources
from codemix_dense_retrieval_torch.io.shards import TORCH_DTYPES, storage_dtype, storage_to_tensor
from codemix_dense_retrieval_torch.io.token_shards import TokenShardStore, TokenShardWriter, token_blocks
from codemix_dense_retrieval_torch.ops.maxsim import maxsim_rerank
from codemix_dense_retrieval_torch.utils.logging import get_logger

# rows per chunk of the int8 -> bf16 dequantization (bounds its f32 temporary)
_DEQUANT_ROWS = 8192


def _dequant_bf16(tokens: torch.Tensor, scales: Optional[torch.Tensor]) -> torch.Tensor:
    """Stored token blocks (n, Td, d) -> the blocks MaxSim scores: int8
    blocks become ``bf16(f32(v) * scale)`` per token, a chunk of rows at a
    time; other dtypes pass through."""
    if scales is None:
        return tokens
    out = torch.empty(tokens.shape, dtype=torch.bfloat16, device=tokens.device)
    for r0 in range(0, tokens.shape[0], _DEQUANT_ROWS):
        r1 = r0 + _DEQUANT_ROWS
        out[r0:r1] = (tokens[r0:r1].to(torch.float32) * scales[r0:r1, :, None]).to(torch.bfloat16)
    return out


def _rerank_block_unique(
    q_tokens: torch.Tensor,            # (B, Tq, d) f32
    q_mask: torch.Tensor,              # (B, Tq)
    u_tokens: torch.Tensor,            # (U, Td, d) unique candidate blocks
    u_scales: Optional[torch.Tensor],  # (U, Td) or None
    u_mask: torch.Tensor,              # (U, Td)
    inv: torch.Tensor,                 # (B, K) -> row in the unique set
    cand_ids: torch.Tensor,            # (B, K) global row ids
    *,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rerank with host-deduplicated candidates: queries of a block share
    documents, so only the unique blocks cross to the device; they are
    dequantized once and expanded on the device."""
    u = _dequant_bf16(u_tokens, u_scales)
    b, kb = inv.shape
    flat = inv.reshape(-1)
    d_tokens = u.index_select(0, flat).reshape(b, kb, *u.shape[1:])
    d_mask = u_mask.index_select(0, flat).reshape(b, kb, -1)
    scores, ids = maxsim_rerank(q_tokens, q_mask, d_tokens, d_mask, cand_ids)
    return scores[:, :k], ids[:, :k]


def _rerank_block_resident(
    q_tokens: torch.Tensor,               # (B, Tq, d) f32
    q_mask: torch.Tensor,                 # (B, Tq)
    tok_dev: torch.Tensor,                # (count, Td, d) card-resident token blocks
    scales_dev: Optional[torch.Tensor],   # (count, Td) f32 or None
    lengths_dev: torch.Tensor,            # (count,) int32
    cand_ids: torch.Tensor,               # (B, K) global row ids
    *,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rerank against a card-resident token store: the candidate gather is a
    row gather in device memory, with no host gather or transfer."""
    b, kb = cand_ids.shape
    flat = cand_ids.reshape(-1)
    sc = None if scales_dev is None else scales_dev.index_select(0, flat)
    d_tok = _dequant_bf16(tok_dev.index_select(0, flat), sc)
    td = tok_dev.shape[1]
    lens = lengths_dev.index_select(0, flat)
    mask = (torch.arange(td, device=lens.device)[None, :] < lens[:, None]).to(torch.int32)
    scores, ids = maxsim_rerank(
        q_tokens, q_mask, d_tok.reshape(b, kb, td, -1), mask.reshape(b, kb, td), cand_ids
    )
    return scores[:, :k], ids[:, :k]


def _rerank_block(
    q_tokens: torch.Tensor,            # (B, Tq, d) f32
    q_mask: torch.Tensor,              # (B, Tq)
    d_tokens: torch.Tensor,            # (B, K, Td, d) int8 | bf16 | f32
    d_scales: Optional[torch.Tensor],  # (B, K, Td) f32 per token, or None
    d_mask: torch.Tensor,              # (B, K, Td)
    cand_ids: torch.Tensor,            # (B, K) global row ids
    *,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, kb = cand_ids.shape
    if d_scales is not None:
        d_tokens = _dequant_bf16(d_tokens.flatten(0, 1), d_scales.flatten(0, 1)).reshape(
            b, kb, *d_tokens.shape[2:]
        )
    scores, ids = maxsim_rerank(q_tokens, q_mask, d_tokens, d_mask, cand_ids)
    return scores[:, :k], ids[:, :k]


def _check_row_alignment(index: DenseFlatIndex, token_store: TokenShardStore) -> None:
    """Fail fast when the token store's rows are not the index's rows: the
    rerank gathers token blocks BY ROW ID, so any docid or row-order drift
    would score the wrong blocks. Every row up to 65,536 rows, a fixed
    1,024-row sample beyond."""
    idx_ids = getattr(index.store, "docids", None)
    tok_ids = token_store.docids
    if idx_ids is None or tok_ids is None:
        return
    n = len(tok_ids)
    if n <= 65536:
        rows = range(n)
    else:
        step = max(1, n // 1024)
        rows = sorted({0, n - 1, *range(0, n, step)})
    for r in rows:
        if idx_ids[r] != tok_ids[r]:
            raise ValueError(
                f"token store row {r} is docid {tok_ids[r]!r} but the index has "
                f"{idx_ids[r]!r}: row orders desynced (rebuild the token store from "
                "the same encode pass as the index)"
            )


class TwoStageSearcher:
    """Dense recall + MaxSim rerank over an (index, token store) pair that
    describe the same corpus in the same row order (the corpus encode writes
    both in one pass). The searcher runs on the index's device."""

    def __init__(
        self,
        index: DenseFlatIndex,
        token_store: TokenShardStore,
        *,
        dedupe: bool = True,
        device_resident: Optional[bool] = None,
        device_budget_bytes: int = 6 << 30,
        approx=False,
    ) -> None:
        if index.count != token_store.count:
            raise ValueError(
                f"index count {index.count} != token store count {token_store.count} "
                "(not the same corpus?)"
            )
        # a mutated (or reordered) index's row ids no longer map to token
        # store rows; mutations go through this searcher's add/remove, which
        # mirror them onto the resident token blocks
        if index.mutation_epoch:
            raise ValueError(
                "dense index was mutated (add/remove) before this TwoStageSearcher was built: "
                "its row ids no longer align with the token store; rebuild both from the same corpus"
            )
        _check_row_alignment(index, token_store)
        if index.device is None:
            index.to_device()
        self._index_epoch = 0
        self.index = index
        self.tokens = token_store
        self.device = index.device
        # ship only the unique candidate blocks of a query block when that
        # is fewer bytes; the results are the same
        self.dedupe = dedupe
        # the dense stage's search tier (True / "guaranteed" / "adaptive"),
        # passed to the index
        self.approx = approx
        # effective depths of the most recent search() (k_dense may clamp)
        self.last_depths: dict = {}
        self.count = index.count
        # the token store on the card when it fits the budget: the candidate
        # gather is then a device row gather; None = decide by size
        if device_resident is None:
            device_resident = self._store_bytes() <= device_budget_bytes
        elif device_resident and self._store_bytes() > device_budget_bytes:
            raise ValueError(
                f"token store needs {self._store_bytes() / 2**30:.1f} GiB on the device "
                f"but the budget is {device_budget_bytes / 2**30:.1f} GiB"
            )
        self.device_resident = bool(device_resident)
        self._tok_dev = self._scales_dev = self._lengths_dev = None
        if self.device_resident:
            self._upload_store()

    def _store_bytes(self) -> int:
        ts = self.tokens
        n, td = ts.count, ts.tokens_per_doc
        total = n * td * ts.token_dim * storage_dtype(ts.dtype).itemsize + n * 4  # blocks + lengths
        if ts.token_scales is not None:
            total += n * td * 4  # per-token scales
        return total

    def _upload_store(self) -> None:
        """Copy the store to the device, 65,536 rows at a time."""
        ts = self.tokens
        n = ts.count
        self._tok_dev = torch.empty(
            (n, ts.tokens_per_doc, ts.token_dim), dtype=TORCH_DTYPES[ts.dtype], device=self.device
        )
        if ts.token_scales is not None:
            self._scales_dev = torch.empty((n, ts.tokens_per_doc), dtype=torch.float32, device=self.device)
        for start in range(0, n, 65536):
            rows = np.arange(start, min(start + 65536, n))
            t, s, _ = ts.gather_quantized(rows)
            self._tok_dev[start : start + len(rows)].copy_(storage_to_tensor(t, ts.dtype))
            if s is not None:
                self._scales_dev[start : start + len(rows)].copy_(torch.from_numpy(s))
        self._lengths_dev = torch.from_numpy(np.asarray(ts.lengths, np.int32)).to(self.device)

    def save(self, directory) -> None:
        """Persist the live two-stage corpus: the dense index under
        ``directory`` and the token store under ``directory/tokens`` (the
        encode-corpus layout). Once mutated, the card-resident blocks are
        read back in the dense side's live row order, 4,096 at a time,
        dequantized for the writer (whose per-token quantizer gives the same
        codes and scales back)."""
        directory = pathlib.Path(directory)
        self.index.save(directory)
        ts = self.tokens
        w = TokenShardWriter(directory / "tokens", token_dim=ts.token_dim,
                             tokens_per_doc=ts.tokens_per_doc, dtype=ts.dtype)
        if self._index_epoch == 0 or not self.device_resident:
            ids = list(self.index.docids[: ts.count])
            all_lens = np.asarray(ts.lengths, np.int32)
            for start in range(0, ts.count, 65536):
                rows = np.arange(start, min(start + 65536, ts.count))
                blocks, _ = ts.gather(rows)
                w.append(blocks, all_lens[rows], [str(x) for x in ids[start : start + len(rows)]])
            w.finalize()
            return
        live = self.index._live_positions()  # global padded positions, shards in order
        docids = self.index.docids
        for start in range(0, len(live), 4096):
            pos = live[start : start + 4096]
            rows = torch.from_numpy(pos).to(self.device)
            blocks = self._tok_dev.index_select(0, rows).to(torch.float32)
            if self._scales_dev is not None:
                blocks = blocks * self._scales_dev.index_select(0, rows)[..., None]
            w.append(blocks, self._lengths_dev.index_select(0, rows).cpu().numpy(),
                     [str(x) for x in docids[pos]])
        w.finalize()

    # ---------------- online mutation (card-resident store) ----------------
    #
    # The memmap token store is read-only, so two-stage mutation needs the
    # card-resident blocks, padded to the dense index's capacity over all its
    # shards (one block per global padded position): adds write new blocks at
    # the positions the dense add assigned, removes replay the dense side's
    # swap journal (index.last_swaps), so both stay row-aligned.

    def _mutation_capacity(self) -> int:
        if not self.device_resident:
            raise ValueError(
                "two-stage mutation requires the device-resident token store (the memmap "
                "store is read-only); construct with device_resident=True"
            )
        cap = self.index.mesh.shape["shard"] * self.index._rows_per_shard
        pad = cap - self._tok_dev.shape[0]
        if pad > 0:  # zero blocks, scales 1.0 (a zero token's), length 0
            tok, sc, ln = self._tok_dev, self._scales_dev, self._lengths_dev
            self._tok_dev = torch.cat([tok, tok.new_zeros((pad, *tok.shape[1:]))])
            if sc is not None:
                self._scales_dev = torch.cat([sc, sc.new_ones((pad, sc.shape[1]))])
            self._lengths_dev = torch.cat([ln, ln.new_zeros(pad)])
        return cap

    def add(self, vectors, docids, token_embs, lengths) -> np.ndarray:
        """Two-stage ``add_with_ids``: dense rows and token blocks (n, T,
        token_dim), numpy or a tensor on any device (the encoder's stay on
        the card) land at the same positions; the blocks are cut to
        ``tokens_per_doc``, masked past ``lengths`` and quantized where they
        lie. Raises before anything changes if the add would regrow the
        dense index: the resident token layout cannot follow a regrow, so
        build over an index with headroom."""
        cap = self._mutation_capacity()
        n_new = len(vectors)
        if n_new > cap - self.index.count:
            raise ValueError(
                f"add of {n_new} rows would regrow the dense index (spare capacity "
                f"{cap - self.index.count}); rebuild the searcher over a roomier index instead"
            )
        ts = self.tokens
        if not isinstance(token_embs, torch.Tensor):
            token_embs = torch.from_numpy(np.asarray(token_embs, np.float32))
        lengths, blocks, scales = token_blocks(
            token_embs.to(self.device), lengths, ts.tokens_per_doc, ts.token_dim, ts.dtype
        )
        positions = self.index.add(vectors, docids)
        pos = torch.from_numpy(positions).to(self.device)
        self._tok_dev.index_copy_(0, pos, blocks)
        if scales is not None:
            self._scales_dev.index_copy_(0, pos, scales)
        self._lengths_dev.index_copy_(0, pos, torch.from_numpy(lengths).to(self.device))
        self.count = self.index.count
        self._index_epoch = self.index.mutation_epoch
        return positions

    def remove(self, docids) -> int:
        """Two-stage ``remove_ids``: the dense side swap-deletes, and its
        (src, dst) journal replays on the resident blocks with chains
        resolved to their pre-batch sources, one gather and one scatter."""
        self._mutation_capacity()
        removed = self.index.remove(docids)
        if removed and self.index.last_swaps:
            dst = np.fromiter(dict.fromkeys(d for _, d in self.index.last_swaps), np.int64)
            src = torch.from_numpy(swap_sources(self.index.last_swaps, dst)).to(self.device)
            dst = torch.from_numpy(dst).to(self.device)
            for t in (self._tok_dev, self._scales_dev, self._lengths_dev):
                if t is not None:
                    t.index_copy_(0, dst, t.index_select(0, src))
        if removed:
            self.count = self.index.count
            self._index_epoch = self.index.mutation_epoch
        return removed

    def _to_device(self, arr: np.ndarray, dtype_name: Optional[str] = None) -> torch.Tensor:
        t = storage_to_tensor(arr, dtype_name) if dtype_name else torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(self.device)

    def search(
        self,
        q_vecs: np.ndarray,     # (B, dim) dense query embeddings
        q_tokens: np.ndarray,   # (B, Tq, token_dim) query token embeddings
        q_lengths: np.ndarray,  # (B,) valid query tokens
        k: int,
        *,
        k_dense: Optional[int] = None,
        query_block: int = 0,
        return_docids: bool = True,
        probe_bins: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-``k`` by MaxSim among the dense stage's top-``k_dense``
        (default ``max(4*k, 100)``, ColBERTv2's rerank depth). Returns
        (scores (B, k) f32, docids object / global row ids)."""
        if self.index.mutation_epoch != self._index_epoch:
            raise ValueError(
                "dense index mutated since this TwoStageSearcher was built: dense row ids would "
                "score the WRONG token blocks; rebuild the searcher (token-store mutation is not supported)"
            )
        if k_dense is None:
            k_dense = max(4 * k, 100)
        k_dense = max(k_dense, k)
        q_tokens = np.asarray(q_tokens, np.float32)
        b, tq, _ = q_tokens.shape
        q_mask = (np.arange(tq)[None, :] < np.asarray(q_lengths)[:, None]).astype(np.int32)
        _, gids = self.index.search(
            q_vecs, k_dense, return_docids=False, query_block=query_block,
            approx=self.approx, probe_bins=probe_bins,
        )
        k_got = gids.shape[1]  # the index may clamp k_dense on a small corpus
        if k_got < k_dense:
            get_logger("rerank").warning(
                "rerank k_dense=%d clamped to %d by the dense index (count=%d); final k=%d -> %d",
                k_dense, k_got, self.index.count, k, min(k, k_got),
            )
        self.last_depths = {
            "k_requested": int(k), "k_effective": int(min(k, k_got)),
            "k_dense_requested": int(k_dense), "k_dense_effective": int(k_got),
        }
        k = min(k, k_got)
        blocks = [np.arange(b)] if not query_block else [
            np.arange(i, min(i + query_block, b)) for i in range(0, b, query_block)
        ]
        common = dict(k=k)

        def queries_of(rows):
            return self._to_device(q_tokens[rows]), self._to_device(q_mask[rows])

        results = []
        if self.device_resident:
            for rows in blocks:
                results.append(_rerank_block_resident(
                    *queries_of(rows), self._tok_dev, self._scales_dev, self._lengths_dev,
                    self._to_device(gids[rows]), **common,
                ))
        else:
            results = self._search_memmap(blocks, gids, queries_of, common)
        scores = torch.cat([s for s, _ in results]).cpu().numpy()
        ids = torch.cat([i for _, i in results]).cpu().numpy()
        if not return_docids:
            return scores, ids
        return scores, self.index.docids[ids]

    def _search_memmap(self, blocks, gids, queries_of, common):
        """The host path: the memmap gather of block i+1 runs on a prefetch
        thread while block i is reranked."""
        dtype = self.tokens.dtype

        def gather(rows):
            sub = gids[rows]
            if self.dedupe:
                uniq, inv = np.unique(sub, return_inverse=True)
                # few duplicates make dedupe pure overhead
                if len(uniq) <= 0.9 * sub.size:
                    toks, scales, mask = self.tokens.gather_quantized(uniq)
                    return rows, sub, toks, scales, mask, inv.reshape(sub.shape)
            toks, scales, mask = self.tokens.gather_quantized(sub.ravel())
            kb = sub.shape[1]
            return (
                rows, sub, toks.reshape(len(rows), kb, *toks.shape[1:]),
                None if scales is None else scales.reshape(len(rows), kb, -1),
                mask.reshape(len(rows), kb, -1), None,
            )

        results = []
        block_it = iter(blocks)
        with ThreadPoolExecutor(max_workers=1) as ex:
            futs = deque(ex.submit(gather, r) for r in itertools.islice(block_it, 2))
            while futs:
                rows, sub, toks, scales, mask, inv = futs.popleft().result()
                nxt = next(block_it, None)
                if nxt is not None:
                    futs.append(ex.submit(gather, nxt))
                toks_d = self._to_device(toks, dtype)
                scales_d = None if scales is None else self._to_device(scales)
                args = (*queries_of(rows), toks_d, scales_d, self._to_device(mask))
                cand = self._to_device(sub)
                if inv is not None:
                    results.append(_rerank_block_unique(*args, self._to_device(inv), cand, **common))
                else:
                    results.append(_rerank_block(*args, cand, **common))
        return results


def _write_run_meta(path, tag, n_queries, depths) -> None:
    """Per-run meta with the EFFECTIVE search depths (the dense index may
    clamp ``k_dense`` on a small corpus)."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"tag": tag, "n_queries": int(n_queries), **(depths or {})}, f, indent=2)


def _encode_or_load_queries(encoder, set_name, qids, texts, batch_size, cache_root, log):
    """Query (dense, token) embeddings through an optional on-disk cache,
    ``<cache_root>/<set>.npz``."""
    from codemix_dense_retrieval_torch.pipeline.query_cache import (
        QueryCacheMismatch,
        load_query_token_cache,
        save_query_token_cache,
    )

    cache_path = pathlib.Path(cache_root) / f"{set_name}.npz" if cache_root else None
    if cache_path is not None and cache_path.exists():
        try:
            _, qvecs, qtoks, qlens = load_query_token_cache(cache_path, expected_qids=qids)
            return qvecs, qtoks, qlens
        except QueryCacheMismatch:
            log.warning("stale query token cache %s; re-encoding", cache_path)
    qvecs = encoder.encode_queries(texts, batch_size=batch_size)
    qtoks, qlens = encoder.encode_queries_tokens(texts, batch_size=batch_size)
    if cache_path is not None:
        save_query_token_cache(cache_path, qids, qvecs, qtoks, qlens)
    return qvecs, qtoks, qlens


def run_two_stage_bilingual(
    indexes,       # per-language DenseFlatIndex (device-resident)
    token_stores,  # the matching per-language TokenShardStore
    encoder,
    query_sets,
    outdir,
    *,
    k: int = 500,
    k_dense: Optional[int] = None,
    batch_size: int = 64,
    query_block: int = 256,
    tag: str = "bilingual-twostage",
    max_queries: int = 0,
    cache_root=None,
    approx=False,
):
    """Two-stage search over a bilingual hub, one language at a time: each
    language's (index, token store) pair is searched two-stage at depth
    ``k``, and the per-language results merge by (score desc, language
    order, row id), the tie order a concatenated hub index would give.
    Dense recall runs per language at the full ``k_dense`` depth, a superset
    of what a concatenated hub would give each language. Then docids
    collapse by max score (:func:`~codemix_dense_retrieval_torch.io.trec.collapse_run_max`).
    Writes ``<set>_raw.trec``, ``<set>_base.trec`` and ``<set>_meta.json``
    per set; the meta carries each language's effective depths when they
    differ."""
    from codemix_dense_retrieval_torch.io.trec import collapse_run_max, write_run

    log = get_logger("rerank")
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    searchers = [TwoStageSearcher(ix, ts, approx=approx) for ix, ts in zip(indexes, token_stores)]
    out = {}
    for set_name, rows in query_sets.items():
        if max_queries:
            rows = rows[:max_queries]
        qids = [q for q, _ in rows]
        texts = [t for _, t in rows]
        # the queries are shared by the hub's languages: one cache serves all
        qvecs, qtoks, qlens = _encode_or_load_queries(
            encoder, set_name, qids, texts, batch_size, cache_root, log
        )
        per_lang = []
        for li, s in enumerate(searchers):
            sc, ids = s.search(qvecs, qtoks, qlens, k, k_dense=k_dense, query_block=query_block,
                               return_docids=False)
            per_lang.append((sc, ids, li))
        b = len(qids)
        # merge: concatenate the candidates, sort by (-score, language, row)
        sc = np.concatenate([p[0] for p in per_lang], axis=1)
        ids = np.concatenate([p[1] for p in per_lang], axis=1)
        lang = np.concatenate([np.full_like(p[1], p[2]) for p in per_lang], axis=1)
        order = np.lexsort((ids, lang, -sc), axis=1)[:, :k]
        top_sc = np.take_along_axis(sc, order, axis=1)
        top_docids = np.empty((b, order.shape[1]), dtype=object)
        lang_sel = np.take_along_axis(lang, order, axis=1)
        rows_sel = np.take_along_axis(ids, order, axis=1)
        for li, s in enumerate(searchers):
            sel = lang_sel == li
            for qi in range(b):
                m = sel[qi]
                top_docids[qi, m] = s.index.docids[rows_sel[qi, m]]
        raw = outdir / f"{set_name}_raw.trec"
        write_run(raw, qids, top_docids, top_sc, tag=tag)
        base = outdir / f"{set_name}_base.trec"
        collapse_run_max(raw, base, tag=tag)
        # depth clamps can differ per language (a small index): record each
        # language's effective depths, not just the first's
        _write_run_meta(
            outdir / f"{set_name}_meta.json", tag, len(qids),
            searchers[0].last_depths
            if all(s.last_depths == searchers[0].last_depths for s in searchers)
            else {"per_language": [s.last_depths for s in searchers]},
        )
        out[set_name] = base
        log.info("bilingual two-stage run saved: %s", base)
    return out


def run_two_stage_search(
    index: DenseFlatIndex,
    token_store: TokenShardStore,
    encoder,
    query_sets,
    outdir,
    *,
    k: int = 100,
    k_dense: Optional[int] = None,
    batch_size: int = 64,
    query_block: int = 256,
    tag: str = "twostage",
    max_queries: int = 0,
    cache_root=None,
    approx=False,
):
    """Encode (or load from the cache) and two-stage search each query set;
    one ``<set>.trec`` and ``<set>_meta.json`` per set, the dense runners'
    run-file format."""
    from codemix_dense_retrieval_torch.io.trec import write_run

    log = get_logger("rerank")
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    searcher = TwoStageSearcher(index, token_store, approx=approx)
    out = {}
    for set_name, rows in query_sets.items():
        if max_queries:
            rows = rows[:max_queries]
        qids = [q for q, _ in rows]
        texts = [t for _, t in rows]
        qvecs, qtoks, qlens = _encode_or_load_queries(
            encoder, set_name, qids, texts, batch_size, cache_root, log
        )
        scores, docids = searcher.search(qvecs, qtoks, qlens, k, k_dense=k_dense, query_block=query_block)
        run_path = outdir / f"{set_name}.trec"
        write_run(run_path, qids, docids, scores, tag=tag)
        _write_run_meta(outdir / f"{set_name}_meta.json", tag, len(qids), searcher.last_depths)
        out[set_name] = run_path
        log.info("two-stage run saved: %s (%d queries)", run_path, len(qids))
    return out
