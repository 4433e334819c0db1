"""Dense exact inner-product index over a shard store.

Composition:

- **storage**: :class:`~codemix_dense_retrieval_torch.io.shards.ShardStore`
  (bf16 or int8 rows + docid sidecars, memory-mappable), or the bilingual
  hub's stores end to end (:meth:`DenseFlatIndex.merged`);
- **device residency**: rows padded and uploaded to one device
  (:func:`~codemix_dense_retrieval_torch.parallel.sharded_search.shard_rows`),
  with the per-row scales of an int8 store beside them;
- **search**: the bin-max cover over kernel A, or kernel 4 for an int8
  store (:func:`~codemix_dense_retrieval_torch.parallel.sharded_search.sharded_topk_ip`);
- **sketch tier** (:meth:`DenseFlatIndex.enable_sketch`, ``search(approx=True
  | "guaranteed")``): a PCA sketch sidecar on the device, probed by kernel 7,
  with a per-query exactness certificate
  (:func:`~codemix_dense_retrieval_torch.parallel.sharded_search.sharded_topk_ip_sketch`).

The row id -> docid remap is a host lookup into the docid table.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from codemix_dense_retrieval_torch.io.shards import ShardStore, concat_stores
from codemix_dense_retrieval_torch.parallel.sharded_search import (
    search_blocks,
    shard_row_sidecar,
    shard_rows,
    sharded_topk_ip,
    sharded_topk_ip_sketch,
)
from codemix_dense_retrieval_torch.utils.devices import DeviceLike, resolve_device
from codemix_dense_retrieval_torch.utils.logging import get_logger

# approx="guaranteed" runs exact search directly when calibrate_sketch
# measured a certificate rate below this floor at the requested depth: a
# sketch pass that certifies (almost) nothing still pays the full exact
# escalation on top
GUARANTEED_CERT_FLOOR = 0.05
# the adaptive tier's keys in sketch.npz, written by the JAX package's
# calibrate_adaptive; the port keeps them when it rewrites the file
_ADAPTIVE_KEYS = ("a_ks", "a_probe_vals", "a_speedup_vals", "a_cert_vals")
_ADAPTIVE_DTYPES = (np.int64, np.int64, np.float32, np.float32)


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
        self._sketch = None  # (sketch, tails, proj, settings) on the device
        self._adaptive_cache: dict = {}  # a_* keys of sketch.npz, kept on rewrite
        self.last_certified: Optional[np.ndarray] = None
        self.last_guaranteed_direct = False
        self.last_guaranteed_route: Optional[str] = None

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

    def _is_int8(self) -> bool:
        return self.store.manifest.dtype == "int8"

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
        self._adaptive_cache = {}
        cache_path = (self.store.dir / "sketch.npz") if (cache and self.store.dir) else None
        if cache_path is not None and cache_path.exists():
            try:
                z = np.load(cache_path, allow_pickle=False)
                if int(z["count"]) == self.store.count and _ADAPTIVE_KEYS[0] in z.files:
                    self._adaptive_cache = {kk: np.asarray(z[kk]) for kk in _ADAPTIVE_KEYS}
                if "proj" in z.files and (
                    z["proj"].shape == (self.dim, sketch_dim)
                    and int(z["count"]) == self.store.count
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
            n = self.count
            stride = max(1, n // max(sample, 1))
            rows = self._docs_dev[:n:stride][:sample].to(torch.float32)
            if self._is_int8():
                rows = rows * self.search_kwargs["doc_scales"][:n:stride][:sample, None]
            proj_np = fit_sketch(rows.cpu().numpy(), sketch_dim, sample=sample)
        proj = torch.from_numpy(proj_np).to(self.device)
        sk, tails = self._project_sketch(proj)
        self._sketch = (sk, tails, proj, {
            "expand": expand, "probe_bins": probe_bins, "probe_by_k": probe_by_k,
            "cert_by_k": cert_by_k, "cache_path": cache_path,
        })
        if cache_path is not None:
            self._save_sketch_cache()
        return self

    def _project_sketch(self, proj: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sketch, tails) over the padded device rows."""
        from codemix_dense_retrieval_torch.ops.sketch import sketch_rows, sketch_rows_int8

        if self._is_int8():
            return sketch_rows_int8(self._docs_dev, self.search_kwargs["doc_scales"], proj)
        return sketch_rows(self._docs_dev, proj)

    def _save_sketch_cache(self) -> None:
        _, _, proj, skw = self._sketch
        path = skw.get("cache_path")
        if path is None:
            return
        probe_by_k, cert_by_k = skw["probe_by_k"], skw.get("cert_by_k", {})
        adaptive = {
            kk: np.asarray(self._adaptive_cache.get(kk, np.zeros(0, dt)), dt)
            for kk, dt in zip(_ADAPTIVE_KEYS, _ADAPTIVE_DTYPES)
        }
        # temp + atomic replace: a torn sketch.npz would break restarts
        tmp = path.with_name(path.stem + ".tmp.npz")
        np.savez(
            tmp,
            proj=proj.cpu().numpy().astype(np.float32),
            count=np.int64(self.store.count),
            probe_ks=np.asarray(sorted(probe_by_k), np.int64),
            probe_vals=np.asarray([probe_by_k[pk] for pk in sorted(probe_by_k)], np.int64),
            cert_ks=np.asarray(sorted(cert_by_k), np.int64),
            cert_vals=np.asarray([cert_by_k[ck] for ck in sorted(cert_by_k)], np.float32),
            **adaptive,
        )
        os.replace(tmp, path)

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
        ``probe_bins`` overrides the sketch's probe depth for this call.
        ``approx="adaptive"`` (the probed-exact tier) is not ported and
        raises."""
        if approx == "adaptive":
            raise NotImplementedError(
                "approx='adaptive' (the adaptive probed-exact tier) is not ported yet: "
                "ROADMAP queue 1, item 15"
            )
        if approx not in (False, True, "guaranteed"):
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
        dtype = self._docs_dev.dtype
        if dtype == torch.int8:
            dtype = torch.float32  # the int8 path quantizes queries on the device
        guaranteed_direct = False
        if approx:
            # The JAX package may route guaranteed mode through its adaptive
            # tier when calibrate_adaptive measured that faster; both routes
            # give the exact results, and the port has no adaptive tier yet
            # (ROADMAP queue 1, item 15), so it always takes the sketch with
            # escalation here.
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
            return sharded_topk_ip(blk.to(dtype), self._docs_dev, self._counts_dev, k, **self.search_kwargs)

        def sketched(blk):
            sk, tails, proj, skw = self._sketch
            probe = probe_bins if probe_bins is not None else skw["probe_by_k"].get(k, skw["probe_bins"])
            return sharded_topk_ip_sketch(
                blk.to(dtype), self._docs_dev, self._counts_dev, sk, tails, proj, k,
                probe_bins=probe, expand=skw["expand"],
                doc_scales=self.search_kwargs.get("doc_scales"), **self._sketch_kernel_kwargs(),
            )

        out = search_blocks(q, query_block, self._rows_per_shard, sketched if approx else exact)
        vals_np, gids_np = out[0].cpu().numpy(), out[1].cpu().numpy()
        self.last_certified = out[2].cpu().numpy() if approx else None
        self.last_guaranteed_direct = guaranteed_direct
        self.last_guaranteed_route = (
            "exact" if guaranteed_direct else ("sketch" if approx == "guaranteed" else None)
        )
        if guaranteed_direct:
            # exact results are the guarantee: an all-True certificate vector
            self.last_certified = np.ones(n_q, bool)
        if approx == "guaranteed" and not self.last_certified.all():
            # escalate only the uncertified queries through exact search
            bad = np.flatnonzero(~self.last_certified)
            ev, eg = search_blocks(q[torch.from_numpy(bad).to(q.device)], query_block, self._rows_per_shard, exact)
            vals_np[bad] = ev.cpu().numpy()
            gids_np[bad] = eg.cpu().numpy()
            self.last_certified = np.ones(n_q, bool)
        if not return_docids:
            return vals_np, gids_np
        return vals_np, self._docids[gids_np]
