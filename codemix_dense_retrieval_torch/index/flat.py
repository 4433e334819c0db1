"""Dense exact inner-product index over a shard store.

Composition:

- **storage**: :class:`~codemix_dense_retrieval_torch.io.shards.ShardStore`
  (bf16 or int8 rows + docid sidecars, memory-mappable), or the bilingual
  hub's stores end to end (:meth:`DenseFlatIndex.merged`);
- **device residency**: rows padded and row-sharded over a device mesh's
  ``shard`` axis, each shard on its device
  (:func:`~codemix_dense_retrieval_torch.parallel.sharded_search.shard_rows`),
  with the per-row scales of an int8 store beside them;
- **search**: the bin-max cover over kernel 5 and ``cover_rescore`` (a
  bf16 or f16 store), kernel A (f32) or kernel 4 (int8)
  (:func:`~codemix_dense_retrieval_torch.parallel.sharded_search.sharded_topk_ip`);
- **sketch tier** (:meth:`DenseFlatIndex.enable_sketch`, ``search(approx=True
  | "guaranteed")``): a PCA sketch sidecar on the device, probed by kernel 7,
  with a per-query exactness certificate
  (:func:`~codemix_dense_retrieval_torch.parallel.sharded_search.sharded_topk_ip_sketch`);
- **adaptive tier** (``search(approx="adaptive")``): the probed-exact cover
  over kernel A with escalation, always exact
  (:func:`~codemix_dense_retrieval_torch.parallel.sharded_search.sharded_topk_ip_adaptive`),
  cheap once :meth:`DenseFlatIndex.reorder_rows` has cluster-ordered the rows;
- **online mutation** (:meth:`DenseFlatIndex.add`, :meth:`~DenseFlatIndex.remove`,
  :meth:`~DenseFlatIndex.rebalance`): rows written into the shards' padded
  capacity on their devices, the valid-row counts updated after them.

Search results carry global padded positions (shard * rows_per_shard +
local row); the position -> docid remap is a host lookup into the docid
table.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from codemix_dense_retrieval_torch.io.shards import ShardManifest, ShardStore, concat_stores, storage_dtype
from codemix_dense_retrieval_torch.io.trec import DocidTable
from codemix_dense_retrieval_torch.ops.quant import quantize_rows
from codemix_dense_retrieval_torch.parallel.mesh import Mesh, as_mesh
from codemix_dense_retrieval_torch.parallel.sharded_search import (
    _ceil_to,
    search_blocks,
    shard_row_sidecar,
    shard_rows,
    sharded_topk_ip,
    sharded_topk_ip_adaptive,
    sharded_topk_ip_sketch,
)
from codemix_dense_retrieval_torch.utils import timing
from codemix_dense_retrieval_torch.utils.devices import DeviceLike, resolve_device
from codemix_dense_retrieval_torch.utils.logging import get_logger

# approx="guaranteed" runs exact search directly when calibrate_sketch
# measured a certificate rate below this floor at the requested depth: a
# sketch pass that certifies (almost) nothing still pays the full exact
# escalation on top
GUARANTEED_CERT_FLOOR = 0.05
# guaranteed mode routes through the (always exact) adaptive probed cover
# when calibrate_adaptive measured at least this speedup over exact search
ADAPTIVE_ROUTE_MARGIN = 1.05
# the kernel-geometry kwargs the adaptive tier takes from to_device
_ADAPTIVE_KERNEL_KWARGS = ("bin_size", "super_size", "tile_n")


def swap_sources(swaps: Sequence[Tuple[int, int]], dst: np.ndarray) -> np.ndarray:
    """The pre-batch row each of the rows ``dst`` holds after the ordered
    (src, dst) moves ``swaps``: a chain (a hole filled from a row that was
    itself filled earlier in the batch) resolves to its first source, so one
    gather and one scatter replay the moves."""
    origin: dict = {}
    for src, d in swaps:
        origin[d] = origin.get(src, src)
    return np.asarray([origin[int(d)] for d in dst], np.int64)


class DenseFlatIndex:
    """Exact IP index over one shard store.

    Typical lifecycle::

        idx = DenseFlatIndex.load(path)          # or .build(vectors, docids)
        idx.to_device()                          # card-resident (or to_device(mesh))
        vals, docids = idx.search(qvecs, k=100)
    """

    def __init__(self, store: ShardStore) -> None:
        self.store = store
        self._docids = np.asarray(store.derived_ids, dtype=object)
        # docid_table()'s cache, dropped wherever the docids change
        self._docid_table: Optional[DocidTable] = None
        self.mesh: Optional[Mesh] = None
        self.device: Optional[torch.device] = None  # the mesh's first shard's
        # per-shard device rows and valid-row counts ((1,) int32), shard order
        self._docs_dev: Optional[list] = None
        self._counts_dev: Optional[list] = None
        self._rows_per_shard = 0
        self.search_kwargs: dict = {}
        self._pad_multiple = 1024
        self._sketch = None  # (per-shard sketches, per-shard tails, proj, settings)
        # calibrate_adaptive's operating points per clamped k: probe depth,
        # measured speedup over exact search, certificate rate (the a_* keys
        # of sketch.npz, in the JAX package's format)
        self._adaptive_cal: dict = {"probe_by_k": {}, "speedup_by_k": {}, "cert_by_k": {}}
        self.last_certified: Optional[np.ndarray] = None
        self.last_adaptive_stats: Optional[dict] = None
        self.last_reorder_stats: Optional[dict] = None
        self.last_guaranteed_direct = False
        self.last_guaranteed_route: Optional[str] = None
        # the host side of online mutation (docids and row of each docid),
        # made at the first add/remove/rebalance; the device rows are the truth
        self._mutable: Optional[dict] = None
        # bumped by every add, remove, rebalance and reorder_rows: consumers
        # of row-aligned sidecars compare it to see that their mapping is stale
        self.mutation_epoch = 0
        # ordered (src, dst) row moves of the most recent remove() batch
        self.last_swaps: list = []
        # host seconds of the mutation steps: the docid table of the first
        # mutation (row_of_s) and each grow (grows: from/to rows, seconds)
        self.mutation_stats: dict = {"row_of_s": None, "grows": []}

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

    @classmethod
    def merged(
        cls, indexes: Sequence["DenseFlatIndex"], lang_tags: Optional[Sequence[str]] = None
    ) -> "DenseFlatIndex":
        """The bilingual hub: the indexes' stores end to end with
        ``base#lang`` derived ids (:func:`~codemix_dense_retrieval_torch.io.shards.concat_stores`;
        the rows stay in their stores until :meth:`to_device` copies them)."""
        return cls(concat_stores([ix.store for ix in indexes], lang_tags))

    # ---------------- properties ----------------

    @property
    def count(self) -> int:
        """Live row count (follows online add/remove)."""
        if self._mutable is not None:
            return self._mutable["count"]
        return self.store.count

    @property
    def dim(self) -> int:
        return self.store.dim

    @property
    def docids(self) -> np.ndarray:
        """Derived docid per row."""
        return self._docids

    def docid_table(self) -> DocidTable:
        """:attr:`docids` as one :class:`~codemix_dense_retrieval_torch.io.trec.DocidTable`
        (a hole of a mutated index is an empty field), for ``write_run(...,
        table=)`` over the row ids of :meth:`search` with
        ``return_docids=False``. Built at first use and kept until the docids
        change; while tracing each build counts ``trec.table_builds``."""
        if self._docid_table is None:
            self._docid_table = DocidTable.build(self._docids)
            timing.count("trec.table_builds")
        return self._docid_table

    def save(self, directory) -> None:
        self.to_store().save(directory)

    # ---------------- device residency ----------------

    def to_device(
        self,
        mesh: Union[Mesh, DeviceLike] = None,
        *,
        pad_multiple: int = 1024,
        **search_kwargs,
    ) -> "DenseFlatIndex":
        """Upload the rows, row-sharded over ``mesh``'s ``shard`` axis (a
        :class:`~codemix_dense_retrieval_torch.parallel.mesh.Mesh`; a device
        is the one-shard mesh on it; default: one shard on the CUDA card,
        raising when there is none). ``search_kwargs`` (``method``,
        ``bin_size``, ``tile_b``, ``tile_n``) pass through to every search.
        An int8 store uploads its int8 rows and its per-row scale sidecar,
        and searches over kernel 4 (half the card memory of bf16)."""
        if self.store.manifest.dtype == "int8" and self.store.scales is None:
            raise ValueError("int8 store has no scales.bin; it cannot be searched")
        self.mesh = mesh if isinstance(mesh, Mesh) else as_mesh(resolve_device(mesh))
        self.device = self.mesh.shard_devices()[0]
        self._pad_multiple = pad_multiple
        self._docs_dev, self._counts_dev, self._rows_per_shard = shard_rows(
            self.store, self.mesh, pad_multiple=pad_multiple
        )
        self.search_kwargs = dict(search_kwargs)
        if self.store.manifest.dtype == "int8":
            self.search_kwargs["doc_scales"] = shard_row_sidecar(
                self.store.scales, self.mesh, self._rows_per_shard
            )
        return self

    def _is_int8(self) -> bool:
        return self.store.manifest.dtype == "int8"

    def _sync(self) -> None:
        for dev in self.mesh.distinct_devices():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _live_positions(self) -> np.ndarray:
        """Global padded positions of the live rows, shards in order: the
        row order of :meth:`to_store` (the store's order while unmutated)."""
        if self._mutable is None:
            return np.arange(self.store.count, dtype=np.int64)
        rps, counts = self._rows_per_shard, self._mutable["counts"]
        return np.concatenate(
            [np.arange(s * rps, s * rps + int(c), dtype=np.int64) for s, c in enumerate(counts)]
        )

    def _by_shard(self, positions: np.ndarray):
        """(shard, batch indices, local positions) for each local shard that
        ``positions`` (global) touch, in shard order."""
        shard = positions // self._rows_per_shard - self.mesh.first_shard
        for s in np.unique(shard):
            sel = np.flatnonzero(shard == s)
            yield int(s), sel, positions[sel] - (self.mesh.first_shard + int(s)) * self._rows_per_shard

    def _rows_at(self, s: int, local: np.ndarray) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Shard ``s``'s rows (and int8 scales) at ``local`` positions on its
        device: a slice when they are one ascending run, else a gather."""
        scales = self.search_kwargs.get("doc_scales")
        if len(local) and local[-1] - local[0] + 1 == len(local) and (np.diff(local) == 1).all():
            sl = slice(int(local[0]), int(local[-1]) + 1)
            return self._docs_dev[s][sl], None if scales is None else scales[s][sl]
        idx = torch.from_numpy(local).to(self._docs_dev[s].device)
        return (self._docs_dev[s].index_select(0, idx),
                None if scales is None else scales[s].index_select(0, idx))

    def _rows_f32(self, positions: np.ndarray) -> np.ndarray:
        """The effective rows (dequantized for int8) at global ``positions``
        as host f32."""
        out = np.empty((len(positions), self.dim), np.float32)
        for s, sel, local in self._by_shard(positions):
            rows, sc = self._rows_at(s, local)
            rows = rows.to(torch.float32)
            if sc is not None:
                rows = rows * sc[:, None]
            out[sel] = rows.cpu().numpy()
        return out

    # ---------------- online mutation ----------------
    #
    # FAISS's IndexIDMap adds and removes rows of a live index. Here the rows
    # sit in capacity-padded shards masked by their valid-row counts: an add
    # writes at the count of the emptiest shard, a remove swaps the last
    # valid row of the hole's shard into it and lowers that count (no
    # tombstones), and a full index grows with headroom. The device rows
    # (with an int8 index's scale sidecar) are the only copy of the live
    # rows; the host keeps the docid of each global padded position and the
    # position of each docid. Positions equal the JAX package's on a mesh of
    # the same shard count, and with them the (score desc, row asc) tie
    # order. An int8 row moves as its bytes: for codes and scales made by the
    # per-row quantizer that equals the JAX package's re-quantization of the
    # dequantized row (quantize(dequantize(q, s)) == (q, s)).

    def _ensure_mutable(self) -> None:
        """Upload the index if it is not on a device, and make the docid
        table of the first mutation (its host seconds in
        ``mutation_stats["row_of_s"]``)."""
        if self._docs_dev is None:
            self.to_device()
        if self._mutable is not None:
            return
        if self.mesh.process_count > 1:
            raise NotImplementedError(
                "online mutation runs on a single-process mesh: each process of a "
                "multi-process mesh holds only its own shards' rows"
            )
        t0 = time.perf_counter()
        n, rps = self.store.count, self._rows_per_shard
        counts = np.asarray([int(c[0]) for c in self._counts_dev], np.int64)
        docids = np.empty(len(counts) * rps, dtype=object)
        docids[:n] = self._docids[:n]
        self._mutable = {
            "count": n,
            "counts": counts,
            "docids": docids,
            "row_of": dict(zip(docids[:n].tolist(), range(n))),
        }
        self._docids = docids
        self._docid_table = None
        self.mutation_stats["row_of_s"] = time.perf_counter() - t0

    def _refresh_counts(self) -> None:
        """The valid-row counts on the shards' devices, enqueued after the
        row writes they unmask."""
        self._counts_dev = [
            torch.tensor([int(c)], dtype=torch.int32, device=dev)
            for c, dev in zip(self._mutable["counts"], self.mesh.shard_devices())
        ]

    def _resketch(self, s: int, local: torch.Tensor) -> None:
        """Sketch and tail rows of shard ``s``'s effective rows at ``local``
        (dequantized for int8) into the armed sketch sidecar."""
        if self._sketch is None:
            return
        from codemix_dense_retrieval_torch.ops.sketch import sketch_rows, sketch_rows_int8

        sk, tails, proj, _ = self._sketch
        rows = self._docs_dev[s].index_select(0, local)
        proj = proj.to(rows.device)
        if self._is_int8():
            new_sk, new_tails = sketch_rows_int8(
                rows, self.search_kwargs["doc_scales"][s].index_select(0, local), proj
            )
        else:
            new_sk, new_tails = sketch_rows(rows, proj)
        sk[s].index_copy_(0, local, new_sk.to(sk[s].dtype))
        tails[s].index_copy_(0, local, new_tails)

    def _reproject_sketch(self) -> None:
        """Re-project an armed sketch over the whole (new) row layout."""
        if self._sketch is not None:
            proj, skw = self._sketch[2], self._sketch[3]
            self._sketch = None  # the old sidecar leaves before the new one is made
            self._sketch = (*self._project_sketch(proj), proj, skw)

    def _write_rows(self, positions: np.ndarray, rows: torch.Tensor) -> None:
        """Write f32 ``rows`` at global ``positions`` in the index dtype, each
        on its shard's device: an int8 index quantizes them there
        (bit-identical to the JAX package's host quantizer) and writes their
        scales."""
        for s, sel, local in self._by_shard(positions):
            dev = self._docs_dev[s].device
            pos = torch.from_numpy(local).to(dev)
            part = rows[torch.from_numpy(sel).to(rows.device)].to(dev, torch.float32)
            if self._is_int8():
                q, scales = quantize_rows(part)
                self._docs_dev[s].index_copy_(0, pos, q)
                self.search_kwargs["doc_scales"][s].index_copy_(0, pos, scales)
            else:
                self._docs_dev[s].index_copy_(0, pos, part.to(self._docs_dev[s].dtype))
            self._resketch(s, pos)

    def _move_rows(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Copy the rows at global ``src`` (with their scales) to ``dst``,
        each pair within one shard; the gather completes before the scatter,
        so chains resolved to their pre-batch sources move in one step."""
        for s, sel, local_dst in self._by_shard(dst):
            dev = self._docs_dev[s].device
            d = torch.from_numpy(local_dst).to(dev)
            c = torch.from_numpy(src[sel] % self._rows_per_shard).to(dev)
            self._docs_dev[s].index_copy_(0, d, self._docs_dev[s].index_select(0, c))
            if self._is_int8():
                scales = self.search_kwargs["doc_scales"][s]
                scales.index_copy_(0, d, scales.index_select(0, c))
            self._resketch(s, d)

    def _relayout(self, rows_per_shard: int, sources: Sequence[np.ndarray]) -> None:
        """Lay the live rows out anew: shard s takes the rows at the global
        positions ``sources[s]`` (in order) in a ``rows_per_shard``-row shard,
        zero rows after them (an int8 index's pad scales 1.0, what the
        quantizer gives a zero row); the counts are refreshed and the sketch
        re-projected: the JAX package's re-upload of its mirror. A shard
        that keeps its rows in place is not copied; a shard's old rows leave
        the device once no later shard reads them."""
        m, old_rps = self._mutable, self._rows_per_shard
        devices = self.mesh.shard_devices()
        dtype = self._docs_dev[0].dtype
        old_scales = self.search_kwargs.get("doc_scales")
        stays = [
            rows_per_shard == old_rps and len(src) == int(m["counts"][s])
            and (src == s * old_rps + np.arange(len(src))).all()
            for s, src in enumerate(sources)
        ]
        last_reader = {}
        for s, src in enumerate(sources):
            for j in np.unique(src // old_rps):
                last_reader[int(j)] = s
        new_docs, new_scales = [], []
        for s, src in enumerate(sources):
            c = len(src)
            if stays[s]:
                rows, scales = self._docs_dev[s], None if old_scales is None else old_scales[s]
            else:
                rows = torch.empty((rows_per_shard, self.dim), dtype=dtype, device=devices[s])
                scales = None if old_scales is None else torch.empty(
                    rows_per_shard, dtype=torch.float32, device=devices[s])
                at = 0
                for j, sel, local in self._by_shard(src):
                    part, part_scales = self._rows_at(j, local)
                    rows[at : at + len(sel)].copy_(part)
                    if scales is not None:
                        scales[at : at + len(sel)].copy_(part_scales)
                    at += len(sel)
            rows[c:].zero_()
            if scales is not None:
                scales[c:].fill_(1.0)
            new_docs.append(rows)
            new_scales.append(scales)
            for j in [j for j, reader in last_reader.items() if reader == s]:
                # no later shard reads old shard j: it leaves the device
                # unless a new shard holds it in place
                self._docs_dev[j] = None
                if old_scales is not None:
                    old_scales[j] = None
        if not all(stays) or rows_per_shard != old_rps:
            docids = np.empty(len(sources) * rows_per_shard, dtype=object)
            for s, src in enumerate(sources):
                docids[s * rows_per_shard : s * rows_per_shard + len(src)] = m["docids"][src]
            moved = any(
                (src != s * rows_per_shard + np.arange(len(src))).any() for s, src in enumerate(sources)
            )
            m["docids"] = self._docids = docids
            self._docid_table = None
            if moved:
                live = np.flatnonzero(docids != None)  # noqa: E711
                m["row_of"] = dict(zip(docids[live].tolist(), live.tolist()))
        m["counts"] = np.asarray([len(src) for src in sources], np.int64)
        self._docs_dev = new_docs
        if old_scales is not None:
            self.search_kwargs["doc_scales"] = new_scales
        self._rows_per_shard = rows_per_shard
        self._refresh_counts()
        self._reproject_sketch()

    def _shard_ranges(self) -> list:
        """Each shard's live rows as global positions (its valid prefix)."""
        rps = self._rows_per_shard
        return [np.arange(s * rps, s * rps + int(c), dtype=np.int64)
                for s, c in enumerate(self._mutable["counts"])]

    def _grow(self, extra: int) -> None:
        """Regrow every shard to ``ceil_to(ceil((int(1.5 * live rows) +
        extra) / S), 1024)`` rows (the JAX package's headroom), each shard
        keeping its rows; the seconds, cards synchronized, land in
        ``mutation_stats["grows"]``."""
        n, shards = self._mutable["count"], len(self._docs_dev)
        target = int(1.5 * n) + extra
        capacity = _ceil_to(max(1, -(-target // shards)), 1024)
        from_rows = self._rows_per_shard
        t0 = time.perf_counter()
        self._relayout(capacity, self._shard_ranges())
        self._sync()
        self.mutation_stats["grows"].append(
            {"from_rows": from_rows, "to_rows": capacity, "seconds": time.perf_counter() - t0}
        )

    def add(self, vectors, docids: Sequence[str]) -> np.ndarray:
        """Add rows to the live index (FAISS ``add_with_ids``): f32 rows
        (numpy or a tensor on any device) written into the shards' pad, the
        emptiest shard first (ties to the lowest), the index regrown when
        its capacity is spent. A docid already present, or twice in the
        batch, raises before anything changes. Returns the global padded row
        positions assigned (row-aligned sidecars, the two-stage token
        blocks, write theirs there)."""
        self._ensure_mutable()
        m = self._mutable
        if not isinstance(vectors, torch.Tensor):
            vectors = torch.from_numpy(np.asarray(vectors, np.float32))
        vectors = vectors.detach()
        if vectors.ndim == 1:
            vectors = vectors[None]
        docids = [str(x) for x in docids]
        if len(docids) != len(vectors):
            raise ValueError(f"{len(vectors)} rows vs {len(docids)} docids")
        # an in-batch duplicate would strand its first copy as a row no
        # remove can reach
        seen: set = set()
        dup = [x for x in docids if x in seen or seen.add(x)]
        if dup:
            raise ValueError(f"duplicate docids within the batch: {dup[:5]}")
        dup = [x for x in docids if x in m["row_of"]]
        if dup:
            raise ValueError(f"docids already present: {dup[:5]}")
        if vectors.shape[1] != self.dim:
            raise ValueError(f"row dim {vectors.shape[1]} != index dim {self.dim}")
        if len(vectors) > len(self._docs_dev) * self._rows_per_shard - m["count"]:
            self._grow(len(vectors))
        rps, counts = self._rows_per_shard, m["counts"]
        if len(counts) == 1:
            positions = np.arange(counts[0], counts[0] + len(vectors), dtype=np.int64)
            counts[0] += len(vectors)
        else:
            positions = np.empty(len(vectors), np.int64)
            for i in range(len(vectors)):
                sh = int(np.argmin(counts))  # emptiest shard, ties to the lowest
                positions[i] = sh * rps + counts[sh]
                counts[sh] += 1
        m["docids"][positions] = docids
        m["row_of"].update(zip(docids, positions.tolist()))
        self._docid_table = None
        m["count"] += len(vectors)
        self.mutation_epoch += 1
        self.last_swaps = []
        # the rows first, then the counts that unmask them: a search between
        # the two never scores an unwritten row as valid
        self._write_rows(positions, vectors)
        self._refresh_counts()
        return positions

    def remove(self, docids: Sequence[str]) -> int:
        """Remove rows by docid (FAISS ``remove_ids``); returns how many were
        removed. Unknown docids are ignored. Each hole takes the last valid
        row of its shard, so the count masks stay exact; ``last_swaps``
        journals the (src, dst) moves in order."""
        self._ensure_mutable()
        m = self._mutable
        rps, counts = self._rows_per_shard, m["counts"]
        touched: dict = {}
        removed = 0
        self.last_swaps = []
        for did in map(str, docids):
            pos = m["row_of"].pop(did, None)
            if pos is None:
                continue
            removed += 1
            sh = pos // rps
            last = sh * rps + int(counts[sh]) - 1
            if pos != last:
                moved = m["docids"][last]
                m["docids"][pos] = moved
                m["row_of"][str(moved)] = pos
                touched[pos] = None
                self.last_swaps.append((int(last), int(pos)))
            m["docids"][last] = None
            counts[sh] -= 1
            m["count"] -= 1
            touched.pop(last, None)  # past the count now
        if removed:
            self.mutation_epoch += 1
            self._docid_table = None
            # the moved rows first, then the lower counts: a search between
            # the two sees at worst a still-counted copy of a live row
            if touched:
                dst = np.fromiter(touched, np.int64)
                self._move_rows(swap_sources(self.last_swaps, dst), dst)
            self._refresh_counts()
        return removed

    def rebalance(self) -> "DenseFlatIndex":
        """Even the live rows out across shards: with ``per = ceil(n / S)``,
        shard s takes the live rows ``[s * per, (s + 1) * per)`` of the
        shard-order listing; the pad past them is cleared and an armed sketch
        re-projected (with one shard the rows stay where they are), as the
        JAX package's re-upload does. ``mutation_epoch`` is bumped."""
        self._ensure_mutable()
        live = self._live_positions()
        shards = len(self._docs_dev)
        per = -(-len(live) // shards) if len(live) else 0
        self.mutation_epoch += 1
        self._relayout(self._rows_per_shard, [live[s * per : (s + 1) * per] for s in range(shards)])
        return self

    def to_store(self) -> ShardStore:
        """The live rows as a host ShardStore (the store itself while the
        index is unmutated): shards in order, read back from the devices
        262,144 rows at a time, docids as the live table names them.
        ``save`` writes it."""
        if self._mutable is None:
            return self.store
        live = self._live_positions()
        vals, scales = self._rows_to_host(live)
        man = self.store.manifest
        return ShardStore(
            ShardManifest(dim=self.dim, dtype=man.dtype, count=len(live), files=[], lang=man.lang,
                          encoder=man.encoder, normalized=man.normalized),
            vals, [str(x) for x in self._mutable["docids"][live]], scales=scales,
        )

    def _rows_to_host(self, positions: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Device rows at global ``positions`` in the host storage dtype,
        with their scales for int8, 262,144 rows at a time. int8 rows are
        rebuilt from their dequantized values, as the JAX package does (the
        per-row quantizer gives the same bytes back)."""
        n = len(positions)
        vals = np.empty((n, self.dim), storage_dtype(self.store.manifest.dtype))
        out_scales = np.empty(n, np.float32) if self._is_int8() else None
        for lo in range(0, n, 262_144):
            hi = min(lo + 262_144, n)
            for s, sel, local in self._by_shard(positions[lo:hi]):
                chunk, sc = self._rows_at(s, local)
                if sc is not None:
                    chunk, sc = quantize_rows(chunk.to(torch.float32) * sc[:, None])
                    out_scales[lo + sel] = sc.cpu().numpy()
                chunk = chunk.cpu()
                if chunk.dtype == torch.bfloat16:
                    chunk = chunk.view(torch.int16)
                vals[lo + sel] = chunk.numpy().view(vals.dtype)
        return vals, out_scales

    # ---------------- sketch tier ----------------

    def enable_sketch(
        self,
        sketch_dim: int = 128,
        *,
        sample: int = 131072,
        expand: float = 4.0,
        probe_bins: Optional[int] = None,
        cache: bool = True,
    ) -> "DenseFlatIndex":
        """Build the approximate tier: fit a PCA sketch on a strided row
        sample (host numpy), project the device rows to a bf16 sketch with
        tail bounds on the device, and arm ``search(..., approx=True)``. An
        int8 index sketches its dequantized rows, so its certificates prove
        parity with the int8 exact path.

        ``cache=True`` keeps the fitted projection (and later
        :meth:`calibrate_sketch` operating points) in ``sketch.npz`` in the
        index directory, in the JAX package's format, so either package
        reuses the other's fit; a cache whose dim or count no longer match is
        ignored."""
        from codemix_dense_retrieval_torch.ops.sketch import fit_sketch

        if self._docs_dev is None:
            self.to_device()
        sketch_dim = min(sketch_dim, self.dim)
        proj_np, probe_by_k, cert_by_k = None, {}, {}
        cache_path = (self.store.dir / "sketch.npz") if (cache and self.store.dir) else None
        if cache_path is not None and cache_path.exists():
            # the adaptive operating points do not depend on sketch_dim
            self.load_adaptive_calibration()
            try:
                z = np.load(cache_path, allow_pickle=False)
                if "proj" in z.files and (
                    z["proj"].shape == (self.dim, sketch_dim)
                    and int(z["count"]) == self.count
                ):
                    proj_np = np.asarray(z["proj"], np.float32)
                    probe_by_k = {int(a): int(b) for a, b in zip(z["probe_ks"], z["probe_vals"])}
                    if "cert_ks" in z.files:
                        cert_by_k = {int(a): float(b) for a, b in zip(z["cert_ks"], z["cert_vals"])}
            except Exception:  # a corrupt or truncated cache: refit
                get_logger("index").warning("ignoring unreadable sketch cache %s (refitting)", cache_path)
        if proj_np is None:
            # strided sample over the live rows, read from the device copy
            # (the same values as the store's: dequantized for int8)
            live = self._live_positions()
            stride = max(1, len(live) // max(sample, 1))
            proj_np = fit_sketch(self._rows_f32(live[::stride][:sample]), sketch_dim, sample=sample)
        proj = torch.from_numpy(proj_np).to(self.device)
        sk, tails = self._project_sketch(proj)
        self._sketch = (sk, tails, proj, {
            "expand": expand, "probe_bins": probe_bins, "probe_by_k": probe_by_k,
            "cert_by_k": cert_by_k, "cache_path": cache_path,
        })
        if cache_path is not None:
            self._save_sketch_cache()
        return self

    def _project_sketch(self, proj: torch.Tensor) -> Tuple[list, list]:
        """(sketches, tails) over each shard's padded rows, on its device."""
        from codemix_dense_retrieval_torch.ops.sketch import sketch_rows, sketch_rows_int8

        sketches, tails = [], []
        for s, rows in enumerate(self._docs_dev):
            p = proj.to(rows.device)
            if self._is_int8():
                sk, tl = sketch_rows_int8(rows, self.search_kwargs["doc_scales"][s], p)
            else:
                sk, tl = sketch_rows(rows, p)
            sketches.append(sk)
            tails.append(tl)
        return sketches, tails

    def _save_sketch_cache(self) -> None:
        _, _, proj, skw = self._sketch
        path = skw.get("cache_path")
        if path is None:
            return
        probe_by_k, cert_by_k = skw["probe_by_k"], skw.get("cert_by_k", {})
        self._write_npz(
            path,
            proj=proj.cpu().numpy().astype(np.float32),
            probe_ks=np.asarray(sorted(probe_by_k), np.int64),
            probe_vals=np.asarray([probe_by_k[pk] for pk in sorted(probe_by_k)], np.int64),
            cert_ks=np.asarray(sorted(cert_by_k), np.int64),
            cert_vals=np.asarray([cert_by_k[ck] for ck in sorted(cert_by_k)], np.float32),
        )

    def _write_npz(self, path, **arrays) -> None:
        """``sketch.npz`` with ``arrays``, the row count and the adaptive
        operating points (``a_*``), written to a temp file and atomically
        replaced: a torn file would break restarts."""
        acal = self._adaptive_cal
        a_ks = sorted(acal["probe_by_k"])
        tmp = path.with_name(path.stem + ".tmp.npz")
        np.savez(
            tmp,
            **arrays,
            count=np.int64(self.count),
            a_ks=np.asarray(a_ks, np.int64),
            a_probe_vals=np.asarray([acal["probe_by_k"][ak] for ak in a_ks], np.int64),
            a_speedup_vals=np.asarray([acal["speedup_by_k"].get(ak, 0.0) for ak in a_ks], np.float32),
            a_cert_vals=np.asarray([acal["cert_by_k"].get(ak, 0.0) for ak in a_ks], np.float32),
        )
        os.replace(tmp, path)

    def load_adaptive_calibration(self) -> bool:
        """Load :meth:`calibrate_adaptive`'s operating points from this
        index directory's ``sketch.npz`` (written by either package) without
        building a sketch sidecar; True when points were loaded."""
        if not self.store.dir:
            return False
        path = self.store.dir / "sketch.npz"
        if not path.exists():
            return False
        try:
            z = np.load(path, allow_pickle=False)
            if int(z["count"]) != self.count or "a_ks" not in z.files:
                return False
            for ak, pv, sv, cv in zip(z["a_ks"], z["a_probe_vals"], z["a_speedup_vals"], z["a_cert_vals"]):
                self._adaptive_cal["probe_by_k"][int(ak)] = int(pv)
                self._adaptive_cal["speedup_by_k"][int(ak)] = float(sv)
                self._adaptive_cal["cert_by_k"][int(ak)] = float(cv)
            return True
        except Exception:  # a corrupt or truncated cache holds no points
            return False

    def _save_adaptive_cal(self) -> None:
        """Persist the adaptive operating points: with a sketch armed they
        ride its cache; otherwise ``sketch.npz`` keeps its other keys (a
        projection, probe depths) and gets the ``a_*`` ones, and
        :meth:`enable_sketch` treats a file without ``proj`` as a miss."""
        if self._sketch is not None and self._sketch[3].get("cache_path"):
            self._save_sketch_cache()
            return
        if not self.store.dir:
            return
        path = self.store.dir / "sketch.npz"
        extra = {}
        if path.exists():
            try:
                z = np.load(path, allow_pickle=False)
                extra = {kk: np.asarray(z[kk]) for kk in z.files if not kk.startswith("a_") and kk != "count"}
            except Exception:  # an unreadable file: rewrite it with the points alone
                extra = {}
        self._write_npz(path, **extra)

    def _sketch_kernel_kwargs(self) -> dict:
        """The ``to_device(**search_kwargs)`` entries the sketch path takes."""
        from codemix_dense_retrieval_torch.ops.sketch import SKETCH_KERNEL_KWARGS

        return {kk: vv for kk, vv in self.search_kwargs.items() if kk in SKETCH_KERNEL_KWARGS}

    def calibrate_sketch(
        self,
        queries,
        k: int,
        *,
        recall_target: float = 0.99,
        max_probe_factor: int = 64,
        refine_steps: int = 3,
    ) -> dict:
        """Pick the least ``probe_bins`` that reaches ``recall_target`` at
        depth ``k``, measured against this index's own exact search on the
        sample queries: a doubling sweep, then up to ``refine_steps``
        bisection trials between the last failing and the first passing
        probe. The value is remembered per ``k`` (and cached) for later
        ``search(..., approx=True)`` calls, with the certificate rate it
        measured. Returns ``{"probe_bins", "recall", "certified_frac"}``."""
        from codemix_dense_retrieval_torch.ops.sketch import DEFAULT_BIN_SIZE

        if self._sketch is None:
            self.enable_sketch()
        skw = self._sketch[3]
        # search() clamps k and keys probe_by_k by the clamped value
        k = min(k, self.count, self._rows_per_shard)
        bin_size = self._sketch_kernel_kwargs().get("bin_size") or DEFAULT_BIN_SIZE
        _, exact_ids = self.search(queries, k, return_docids=False)
        min_bins = -(-k // bin_size)
        max_bins = self._rows_per_shard // bin_size

        def recall_at(probe: int) -> float:
            skw["probe_by_k"][k] = probe
            _, ids = self.search(queries, k, return_docids=False, approx=True)
            return float(np.mean([
                len(set(ids[q]) & set(exact_ids[q])) / ids.shape[1] for q in range(len(ids))
            ]))

        probe, recall, factor = None, 0.0, 2
        while factor <= max_probe_factor:
            probe = min(min_bins * factor, max_bins)
            recall = recall_at(probe)
            if recall >= recall_target or probe >= max_bins:
                break
            factor *= 2
        if recall >= recall_target and factor > 2:
            lo, hi = min(min_bins * (factor // 2), max_bins), probe
            for _ in range(max(0, refine_steps)):
                mid = (lo + hi) // 2
                if mid <= lo or mid >= hi:
                    break
                r = recall_at(mid)
                if r >= recall_target:
                    hi, probe, recall = mid, mid, r
                else:
                    lo = mid
        # a final pass at the chosen probe leaves its certificates behind
        if skw["probe_by_k"][k] != probe:
            recall = recall_at(probe)
        skw["probe_by_k"][k] = probe
        cert_frac = float(np.mean(self.last_certified))
        skw.setdefault("cert_by_k", {})[k] = cert_frac
        self._save_sketch_cache()
        return {"probe_bins": probe, "recall": recall, "certified_frac": cert_frac}

    # ---------------- adaptive tier ----------------

    def _adaptive_kernel_kwargs(self) -> dict:
        return {kk: vv for kk, vv in self.search_kwargs.items() if kk in _ADAPTIVE_KERNEL_KWARGS}

    def calibrate_adaptive(
        self,
        queries,
        k: int,
        *,
        max_probe_factor: int = 64,
        iters: int = 2,
    ) -> Optional[dict]:
        """Pick the FASTEST measured probe depth for ``search(approx="adaptive")``
        at depth ``k`` on sample queries. The adaptive tier is exact by
        construction, so wall time is the only objective: a doubling sweep
        over probe depths (each timed as the median of ``iters`` calls after
        a warm-up, the card synchronized), keeping the best, stopping once
        everything certifies. Remembers the probe depth (used by later
        adaptive searches), the speedup over this index's exact search and
        the certificate rate; ``search(approx="guaranteed")`` routes through
        the adaptive tier when the speedup clears ``ADAPTIVE_ROUTE_MARGIN``.
        Persisted in ``sketch.npz``. Returns ``None`` on an int8 store
        (adaptive search runs exact search there)."""
        from codemix_dense_retrieval_torch.ops.sketch import DEFAULT_BIN_SIZE

        if self._docs_dev is None:
            self.to_device()
        if self._is_int8():
            return None
        k = min(k, self.count, self._rows_per_shard)
        bin_size = self._adaptive_kernel_kwargs().get("bin_size", DEFAULT_BIN_SIZE)
        min_bins = -(-k // bin_size)
        max_bins = self._rows_per_shard // bin_size

        def timed(fn):
            fn()  # warm
            ts = []
            for _ in range(max(1, iters)):
                self._sync()
                t0 = time.perf_counter()
                fn()
                self._sync()
                ts.append(time.perf_counter() - t0)
            ts.sort()
            return ts[len(ts) // 2]

        t_exact = timed(lambda: self.search(queries, k, return_docids=False))
        best = None  # (t, probe, cert)
        factor = 1
        while factor <= max_probe_factor:
            probe = min(min_bins * factor, max_bins)
            t = timed(lambda: self.search(queries, k, return_docids=False, approx="adaptive", probe_bins=probe))
            cert = float(self.last_adaptive_stats["certified_frac"])
            if best is None or t < best[0]:
                best = (t, probe, cert)
            if cert >= 0.999 or probe >= max_bins or t > 2.0 * best[0]:
                break
            factor *= 2
        t_best, probe, cert = best
        speedup = t_exact / t_best
        self._adaptive_cal["probe_by_k"][k] = probe
        self._adaptive_cal["speedup_by_k"][k] = speedup
        self._adaptive_cal["cert_by_k"][k] = cert
        self._save_adaptive_cal()
        return {"probe_bins": probe, "speedup": speedup, "certified_frac": cert,
                "exact_s": t_exact, "adaptive_s": t_best}

    def _project_rows(self, proj: np.ndarray, chunk: int = 1_000_000) -> np.ndarray:
        """(N, ds) f32 sketch ``rows @ proj`` of the live rows (dequantized
        for int8), on the host. On the card each chunk is projected there in
        f32 (TF32 off) and only the sketch crosses to the host; on the CPU
        it is the host numpy product, in the JAX package's 1M-row chunks."""
        from codemix_dense_retrieval_torch.ops.sketch import full_f32

        live = self._live_positions()
        n = len(live)
        out = np.empty((n, proj.shape[1]), np.float32)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            if self.device.type == "cpu":
                out[lo:hi] = self._rows_f32(live[lo:hi]) @ proj
                continue
            for s, sel, local in self._by_shard(live[lo:hi]):
                rows, scales = self._rows_at(s, local)
                rows = rows.to(torch.float32)
                if scales is not None:
                    rows = rows * scales[:, None]
                with full_f32():
                    out[lo + sel] = (rows @ torch.from_numpy(proj).to(rows.device)).cpu().numpy()
        return out

    def reorder_rows(self, *, sketch_dim: int = 64, sample: int = 131072) -> np.ndarray:
        """Cluster-pack the rows so sketch-space neighbours share bins
        (:func:`~codemix_dense_retrieval_torch.ops.sketch.cluster_bisect_order`):
        the clustering is the row order. Search results are unchanged, but
        the adaptive and sketch tiers concentrate each query's top-k into
        few bins, so ``approx="adaptive"`` certificates fire. Row ids change
        and ``mutation_epoch`` is bumped. Returns ``perm`` (``new_rows ==
        old_rows[perm]``), the JAX package's permutation for the same store.
        A mutated index is reordered from its live rows and docids, and
        leaves mutation behind (the new store is its rows).

        No f32 copy of the index is made on the host: the projection is fit
        on the :func:`~codemix_dense_retrieval_torch.ops.sketch.sample_index`
        rows (the armed sketch's projection when there is one), the rows are
        projected where they lie (:meth:`_project_rows`), the (N, ds) sketch
        is ordered on the host, and the rows are permuted one chunk at a time
        from the device copy into the new store, which is then uploaded. An
        int8 store is rebuilt from its dequantized rows, as the JAX package
        does (the per-row quantizer gives the same bytes back). The host
        seconds of each step land in ``last_reorder_stats``."""
        from codemix_dense_retrieval_torch.ops.sketch import cluster_bisect_order, fit_sketch, sample_index

        if self._docs_dev is None:
            self.to_device()
        stats = self.last_reorder_stats = {}
        t0 = time.perf_counter()

        def lap(name):
            nonlocal t0
            self._sync()
            stats[name] = time.perf_counter() - t0
            t0 = time.perf_counter()

        store, live = self.store, self._live_positions()
        n = len(live)
        if self._sketch is not None:
            proj = self._sketch[2].cpu().numpy().astype(np.float32)
        else:
            rows = self._rows_f32(live[sample_index(n, sample)])
            proj = fit_sketch(rows, min(sketch_dim, self.dim), sample=sample)
            del rows
        lap("fit_s")
        sketch = self._project_rows(proj)
        lap("project_s")
        perm = cluster_bisect_order(sketch)
        del sketch
        lap("order_s")
        new_vals, new_scales = self._rows_to_host(live[perm])
        if self._mutable is not None:
            # the live table: derived ids, which the JAX package's to_store
            # writes as the docids
            docids, derived = self._mutable["docids"][live][perm].tolist(), None
        else:
            docids = np.asarray(store.docids, dtype=object)[perm].tolist()
            derived = (np.asarray(store.derived_ids, dtype=object)[perm].tolist()
                       if store.derived_ids is not store.docids else None)
        self.store = ShardStore(
            ShardManifest(dim=self.dim, dtype=store.manifest.dtype, count=n, files=[],
                          lang=store.manifest.lang, encoder=store.manifest.encoder,
                          normalized=store.manifest.normalized),
            new_vals, docids, derived, scales=new_scales,
        )
        self._docids = np.asarray(self.store.derived_ids, dtype=object)
        self._docid_table = None
        self._mutable = None
        self.last_swaps = []
        self.mutation_epoch += 1
        lap("permute_s")
        kwargs = {kk: vv for kk, vv in self.search_kwargs.items() if kk != "doc_scales"}
        # the old rows and scales leave the cards before the new ones arrive
        self._docs_dev = self.search_kwargs = None
        self.to_device(self.mesh, pad_multiple=self._pad_multiple, **kwargs)
        self._reproject_sketch()
        lap("upload_s")
        return perm

    # ---------------- search ----------------

    def search(
        self,
        queries: Union[np.ndarray, torch.Tensor],
        k: int,
        *,
        return_docids: bool = True,
        query_block: int = 0,
        approx: Union[bool, str] = False,
        probe_bins: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k. Returns (scores (B, k) f32, docids (B, k) object), or raw
        row ids with ``return_docids=False``.

        ``query_block`` processes queries in fixed-size blocks (0 = one
        block), cut on a CUDA card so that one block's scores fit its free
        memory (:func:`~codemix_dense_retrieval_torch.parallel.sharded_search.fit_query_block`);
        a ragged tail block is zero-padded to the block size and its
        results sliced off. Queries are cast to the index dtype before the
        kernel, except over an int8 index, where they stay f32 and are
        quantized on the device.

        ``approx=True`` searches through the sketch tier (:meth:`enable_sketch`
        first, or its defaults are used): approximate, with per-query
        exactness certificates left in ``last_certified``.
        ``approx="guaranteed"`` re-runs the uncertified queries through exact
        search, so the results are always exact; when :meth:`calibrate_sketch`
        measured a certificate rate below ``GUARANTEED_CERT_FLOOR`` at this
        depth it runs exact search directly (``last_guaranteed_direct``).
        When :meth:`calibrate_adaptive` measured the adaptive tier at least
        ``ADAPTIVE_ROUTE_MARGIN`` times faster than exact search at this
        depth, guaranteed mode runs it instead (``last_guaranteed_route ==
        "adaptive"``).

        ``approx="adaptive"`` runs the probed-exact cover with true bin-max
        certificates and the escalation tail: always exact, priced at the
        probe when certificates fire (a row-order property: see
        :meth:`reorder_rows`); per-call stats in ``last_adaptive_stats``. An
        int8 store runs exact search instead (``last_adaptive_stats`` None).
        ``probe_bins`` overrides the probe depth of the adaptive and sketch
        tiers for this call.

        While tracing the call is the span ``search.call``; inside it the
        host's wait for the results is ``search.readback`` and the docid
        lookup ``search.docids``."""
        with timing.span("search.call"):
            return self._search(queries, k, return_docids, query_block, approx, probe_bins)

    def _search(self, queries, k: int, return_docids: bool, query_block: int, approx,
                probe_bins: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
        if approx not in (False, True, "guaranteed", "adaptive"):
            raise ValueError(
                f"approx must be True/False/'adaptive'/'guaranteed', got {approx!r}"
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
        dtype = self._docs_dev[0].dtype
        if dtype == torch.int8:
            dtype = torch.float32  # the int8 path quantizes queries on the device
        if approx == "adaptive" and not self._is_int8():
            return self._search_adaptive(q, k, query_block, probe_bins, return_docids)
        if approx == "adaptive":
            # int8: exact search, whose results are trivially certified
            approx = False
            self.last_adaptive_stats = None
            adaptive_fallback = True
        else:
            adaptive_fallback = False
        guaranteed_direct = False
        if approx == "guaranteed" and not self._is_int8():
            sp = self._adaptive_cal["speedup_by_k"].get(k)
            if sp is not None and sp >= ADAPTIVE_ROUTE_MARGIN:
                get_logger("index").info(
                    "guaranteed search k=%d: routing through the adaptive tier (calibrated speedup %.2fx)",
                    k, sp,
                )
                out = self._search_adaptive(q, k, query_block, probe_bins, return_docids)
                self.last_guaranteed_route = "adaptive"
                return out
        if approx:
            if self._sketch is None:
                self.enable_sketch()
            cr = self._sketch[3].get("cert_by_k", {}).get(k)
            if approx == "guaranteed" and cr is not None and cr < GUARANTEED_CERT_FLOOR:
                get_logger("index").info(
                    "guaranteed search k=%d: calibrated certificate rate %.3f < %.2f; "
                    "using exact search directly", k, cr, GUARANTEED_CERT_FLOOR,
                )
                approx, guaranteed_direct = False, True

        def exact(blk):
            return sharded_topk_ip(
                blk.to(dtype), self._docs_dev, self._counts_dev, k, mesh=self.mesh, **self.search_kwargs
            )

        def sketched(blk):
            sk, tails, proj, skw = self._sketch
            probe = probe_bins if probe_bins is not None else skw["probe_by_k"].get(k, skw["probe_bins"])
            return sharded_topk_ip_sketch(
                blk.to(dtype), self._docs_dev, self._counts_dev, sk, tails, proj, k,
                mesh=self.mesh, probe_bins=probe, expand=skw["expand"],
                doc_scales=self.search_kwargs.get("doc_scales"), **self._sketch_kernel_kwargs(),
            )

        out = search_blocks(q, query_block, self._rows_per_shard, sketched if approx else exact,
                            self.mesh.shard_devices() if approx else self._docs_dev, self.mesh)
        with timing.span("search.readback"):
            vals_np, gids_np = out[0].cpu().numpy(), out[1].cpu().numpy()
            self.last_certified = out[2].cpu().numpy() if approx else None
        self.last_guaranteed_direct = guaranteed_direct
        self.last_guaranteed_route = (
            "exact" if guaranteed_direct else ("sketch" if approx == "guaranteed" else None)
        )
        if guaranteed_direct or adaptive_fallback:
            # exact results are the guarantee: an all-True certificate vector
            self.last_certified = np.ones(n_q, bool)
        if approx == "guaranteed" and not self.last_certified.all():
            # escalate only the uncertified queries through exact search
            bad = np.flatnonzero(~self.last_certified)
            ev, eg = search_blocks(
                q[torch.from_numpy(bad).to(q.device)], query_block, self._rows_per_shard, exact, self._docs_dev,
                self.mesh,
            )
            with timing.span("search.readback"):
                vals_np[bad] = ev.cpu().numpy()
                gids_np[bad] = eg.cpu().numpy()
            self.last_certified = np.ones(n_q, bool)
        if not return_docids:
            return vals_np, gids_np
        with timing.span("search.docids"):
            return vals_np, self._docids[gids_np]

    def _search_adaptive(self, q: torch.Tensor, k: int, query_block: int, probe_bins: Optional[int],
                         return_docids: bool) -> Tuple[np.ndarray, np.ndarray]:
        """``search(approx="adaptive")`` over a float index: the calibrated
        probe depth unless ``probe_bins`` is given, the query blocks of
        :func:`~codemix_dense_retrieval_torch.parallel.sharded_search.search_blocks`,
        stats over the blocks in ``last_adaptive_stats``."""
        if probe_bins is None:
            probe_bins = self._adaptive_cal["probe_by_k"].get(k)
        block_stats = []

        def adaptive(blk):
            vals, gids, st = sharded_topk_ip_adaptive(
                blk.to(self._docs_dev[0].dtype), self._docs_dev, self._counts_dev, k,
                mesh=self.mesh, probe_bins=probe_bins, **self._adaptive_kernel_kwargs(),
            )
            block_stats.append(st)
            return vals, gids

        vals, gids = search_blocks(q, query_block, self._rows_per_shard, adaptive, self.mesh.shard_devices(), self.mesh)
        with timing.span("search.readback"):
            vals_np, gids_np = vals.cpu().numpy(), gids.cpu().numpy()
        self.last_certified = np.ones(len(q), bool)  # exact by construction
        self.last_adaptive_stats = {
            "certified_frac": float(np.mean([st["certified_frac"] for st in block_stats])),
            "escalated": int(sum(st.get("escalated", 0) for st in block_stats)),
            "probe_bins": block_stats[0]["probe_bins"],
        }
        self.last_guaranteed_direct = False
        self.last_guaranteed_route = None
        if not return_docids:
            return vals_np, gids_np
        with timing.span("search.docids"):
            return vals_np, self._docids[gids_np]
