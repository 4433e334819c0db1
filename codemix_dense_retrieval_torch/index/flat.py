"""Dense exact inner-product index over a shard store.

Composition:

- **storage**: :class:`~codemix_dense_retrieval_torch.io.shards.ShardStore`
  (bf16 or int8 rows + docid sidecars, memory-mappable);
- **device residency**: rows padded and uploaded to one device
  (:func:`~codemix_dense_retrieval_torch.parallel.sharded_search.shard_rows`),
  with the per-row scales of an int8 store beside them;
- **search**: the bin-max cover over kernel A, or kernel 4 for an int8
  store (:func:`~codemix_dense_retrieval_torch.parallel.sharded_search.sharded_topk_ip`).

The row id -> docid remap is a host lookup into the docid table.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from codemix_dense_retrieval_torch.io.shards import ShardStore
from codemix_dense_retrieval_torch.parallel.sharded_search import (
    shard_row_sidecar,
    shard_rows,
    sharded_topk_ip,
)
from codemix_dense_retrieval_torch.utils.devices import DeviceLike, resolve_device
from codemix_dense_retrieval_torch.utils.logging import get_logger


class DenseFlatIndex:
    """Exact IP index over one shard store.

    Typical lifecycle::

        idx = DenseFlatIndex.load(path)          # or .build(vectors, docids)
        idx.to_device()                          # card-resident
        vals, docids = idx.search(qvecs, k=100)
    """

    def __init__(self, store: ShardStore) -> None:
        self.store = store
        self._docids = np.asarray(store.derived_ids, dtype=object)
        self.device: Optional[torch.device] = None
        self._docs_dev: Optional[torch.Tensor] = None
        self._counts_dev: Optional[torch.Tensor] = None
        self._rows_per_shard = 0
        self.search_kwargs: dict = {}

    # ---------------- constructors ----------------

    @classmethod
    def from_store(cls, store: ShardStore) -> "DenseFlatIndex":
        return cls(store)

    @classmethod
    def build(
        cls,
        vectors,
        docids: Sequence[str],
        *,
        dtype: str = "bfloat16",
        lang: Optional[str] = None,
        encoder: Optional[str] = None,
    ) -> "DenseFlatIndex":
        return cls(ShardStore.build(vectors, docids, dtype=dtype, lang=lang, encoder=encoder))

    @classmethod
    def load(cls, directory) -> "DenseFlatIndex":
        return cls(ShardStore.open(directory))

    # ---------------- properties ----------------

    @property
    def count(self) -> int:
        return self.store.count

    @property
    def dim(self) -> int:
        return self.store.dim

    @property
    def docids(self) -> np.ndarray:
        """Derived docid per row."""
        return self._docids

    def to_store(self) -> ShardStore:
        return self.store

    def save(self, directory) -> None:
        self.to_store().save(directory)

    # ---------------- device residency ----------------

    def to_device(
        self,
        device: DeviceLike = None,
        *,
        pad_multiple: int = 1024,
        **search_kwargs,
    ) -> "DenseFlatIndex":
        """Upload the rows to ``device`` (the CUDA card by default; raises
        when there is none and no device is named). ``search_kwargs``
        (``method``, ``bin_size``, ``tile_b``, ``tile_n``) pass through to
        every search. An int8 store uploads its int8 rows and its per-row
        scale sidecar, and searches over kernel 4 (half the card memory of
        bf16)."""
        if self.store.manifest.dtype == "int8" and self.store.scales is None:
            raise ValueError("int8 store has no scales.bin; it cannot be searched")
        self.device = resolve_device(device)
        self._docs_dev, self._counts_dev, self._rows_per_shard = shard_rows(
            self.store, self.device, pad_multiple=pad_multiple
        )
        self.search_kwargs = dict(search_kwargs)
        if self.store.manifest.dtype == "int8":
            self.search_kwargs["doc_scales"] = shard_row_sidecar(
                self.store.scales, self.device, self._rows_per_shard
            )
        return self

    # ---------------- search ----------------

    def search(
        self,
        queries: Union[np.ndarray, torch.Tensor],
        k: int,
        *,
        return_docids: bool = True,
        query_block: int = 0,
        approx: Union[bool, str] = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k. Returns (scores (B, k) f32, docids (B, k) object), or
        raw row ids with ``return_docids=False``.

        ``query_block`` processes queries in fixed-size blocks (0 = one
        block); a ragged tail block is zero-padded to the block size and its
        results sliced off. Queries are cast to the index dtype before the
        kernel, except over an int8 index, where they stay f32 and are
        quantized on the device. The approximate tiers are not ported: any
        ``approx`` other than False raises."""
        if approx is not False:
            raise NotImplementedError(
                f"approx={approx!r}: the approximate and adaptive tiers are not "
                "ported yet (ROADMAP queue 1, deferred)"
            )
        if self._docs_dev is None:
            self.to_device()
        if not isinstance(queries, torch.Tensor):
            queries = torch.from_numpy(np.asarray(queries, dtype=np.float32))
        q = queries.detach().to(self.device, torch.float32)
        if q.ndim == 1:
            q = q[None]
        if q.shape[1] != self.dim:
            raise ValueError(
                f"query dim {q.shape[1]} != index dim {self.dim} "
                f"(encoder/index mismatch)"
            )
        k_eff = min(k, self.count, self._rows_per_shard)
        if k_eff < k:
            get_logger("index").warning(
                "search k=%d clamped to %d (count=%d, rows_per_shard=%d)",
                k, k_eff, self.count, self._rows_per_shard,
            )
        k = k_eff
        n_q = len(q)
        if query_block and n_q % query_block and n_q > query_block:
            tail_pad = query_block - (n_q % query_block)
            q = torch.cat([q, q.new_zeros((tail_pad, q.shape[1]))])
        blocks = q.split(query_block) if query_block else [q]
        dtype = self._docs_dev.dtype
        if dtype == torch.int8:
            dtype = torch.float32  # the int8 path quantizes queries on the device
        vals, gids = [], []
        for blk in blocks:
            v, g = sharded_topk_ip(
                blk.to(dtype), self._docs_dev, self._counts_dev, k, **self.search_kwargs
            )
            vals.append(v)
            gids.append(g)
        vals_np = torch.cat(vals).cpu().numpy()[:n_q]
        gids_np = torch.cat(gids).cpu().numpy()[:n_q]
        if not return_docids:
            return vals_np, gids_np
        return vals_np, self._docids[gids_np]
