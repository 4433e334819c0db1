"""Embedding shard store — the on-disk index format.

Directory layout (unchanged from the JAX package, so a store written by
one package opens in the other):

    <dir>/manifest.json   {"dim", "dtype", "count", "files": [{"name","rows"}...],
                           "lang", "encoder", "normalized", "extra"}
    <dir>/emb.00000.bin   raw row-major embeddings (bf16 by default)
    <dir>/docids.txt      base docid per row (row order == vector order)
    <dir>/docid_map.tsv   int_id \\t derived_id \\t base_id \\t lang
    <dir>/scales.bin      per-row f32 scales (int8 storage only)

Float rows stored as int8 are quantized per row
(:func:`~codemix_dense_retrieval_torch.ops.quant.quantize_rows_np`) and
their scales appended to ``scales.bin``. numpy has no bfloat16, so bf16
rows are held host-side as their raw 16-bit patterns (``np.uint16``) and
reinterpreted as ``torch.bfloat16`` at the tensor boundary
(:func:`storage_to_tensor`); float -> bf16 conversion rounds to nearest
even, the same rounding the JAX package's writer applies.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from codemix_dense_retrieval_torch.ops.quant import quantize_rows_np
from codemix_dense_retrieval_torch.utils import timing

PathLike = os.PathLike | str

_NP_DTYPES = {
    "bfloat16": np.dtype(np.uint16),  # raw bf16 bit patterns
    "float32": np.dtype(np.float32),
    "float16": np.dtype(np.float16),
    "int8": np.dtype(np.int8),
}

TORCH_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
    "int8": torch.int8,
}


def storage_dtype(name: str) -> np.dtype:
    """Host numpy dtype a storage dtype is held in."""
    if name not in _NP_DTYPES:
        raise ValueError(f"unsupported storage dtype {name!r} (use {sorted(_NP_DTYPES)})")
    return _NP_DTYPES[name]


def to_storage(vecs, name: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Convert rows (numpy array or torch tensor) to the host storage array
    of dtype ``name``; returns (rows, scales). Float rows stored as int8 are
    quantized per row and their f32 scales returned; every other case
    returns ``None`` scales. A CPU bf16 tensor is viewed, not copied."""
    storage_dtype(name)
    if name == "int8":
        if isinstance(vecs, torch.Tensor):
            vecs = vecs.detach().cpu()
            vecs = (vecs.float() if vecs.is_floating_point() else vecs).numpy()
        vecs = np.asarray(vecs)
        if vecs.dtype == np.int8:
            return np.ascontiguousarray(vecs), None
        return quantize_rows_np(vecs)
    t = vecs if isinstance(vecs, torch.Tensor) else torch.from_numpy(np.asarray(vecs))
    t = t.detach().to("cpu", TORCH_DTYPES[name]).contiguous()
    if name == "bfloat16":
        return t.view(torch.int16).numpy().view(np.uint16), None
    return t.numpy(), None


def storage_to_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    """Host storage rows -> CPU tensor of the storage's torch dtype (copies,
    so read-only memmaps are safe to hand over)."""
    host = np.array(arr, copy=True)
    if name == "bfloat16":
        return torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(host)


@dataclass
class ShardManifest:
    dim: int
    dtype: str
    count: int
    files: List[Dict]
    lang: Optional[str] = None
    encoder: Optional[str] = None
    normalized: bool = True
    extra: Dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ShardManifest":
        d = json.loads(text)
        return cls(**{k: d[k] for k in ("dim", "dtype", "count", "files")},
                   lang=d.get("lang"), encoder=d.get("encoder"),
                   normalized=d.get("normalized", True), extra=d.get("extra", {}))


class ShardWriter:
    """Streaming writer: ``append`` writes rows to the current bin file
    (flushed) and ``finalize`` writes the manifest last, so a finished
    manifest means a complete store. While tracing they are the spans
    ``store.append`` (its rows counted under ``store.rows``) and
    ``store.finalize``."""

    def __init__(
        self,
        out_dir: PathLike,
        dim: int,
        dtype: str = "bfloat16",
        *,
        lang: Optional[str] = None,
        encoder: Optional[str] = None,
        normalized: bool = True,
        rows_per_file: int = 1_000_000,
    ) -> None:
        self.dir = pathlib.Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.dim = dim
        self.dtype_name = dtype
        storage_dtype(dtype)
        self.lang = lang
        self.encoder = encoder
        self.normalized = normalized
        self.rows_per_file = rows_per_file
        self.count = 0
        self.files: List[Dict] = []
        self._docids: List[str] = []
        self._derived: List[str] = []
        self._fh = None
        self._rows_in_file = 0

    @classmethod
    def resume_partial(
        cls, out_dir: PathLike, dim: int, dtype: str = "bfloat16", **kw
    ) -> Tuple["ShardWriter", set]:
        """Reopen an unfinalized shard directory, positioned after the rows
        already written (mid-language crash recovery).

        Returns (writer, already-written docids); rows whose docids are in
        that set must not be appended again. A torn trailing row is cut off;
        the docid and (int8) scale sidecars are written before the rows, so
        they may run ahead by one batch after a crash and are truncated to
        the row count."""
        w = cls(out_dir, dim, dtype, **kw)
        partial = w.dir / "docids.partial.txt"
        existing: List[str] = []
        if partial.exists():
            existing = [line for line in partial.read_text(encoding="utf-8").splitlines() if line]
        row_bytes = storage_dtype(dtype).itemsize * dim
        total_rows = 0
        idx = 0
        while True:
            path = w.dir / f"emb.{idx:05d}.bin"
            if not path.exists():
                break
            size = path.stat().st_size
            rows = size // row_bytes
            if size % row_bytes:
                with open(path, "r+b") as fh:
                    fh.truncate(rows * row_bytes)
            w.files.append({"name": path.name, "rows": rows})
            total_rows += rows
            idx += 1
        existing = existing[:total_rows]
        scales_path = w.dir / "scales.bin"
        if dtype == "int8" and scales_path.exists():
            want = total_rows * np.dtype(np.float32).itemsize
            if scales_path.stat().st_size > want:
                with open(scales_path, "r+b") as fh:
                    fh.truncate(want)
            elif scales_path.stat().st_size < want:
                raise ValueError(
                    f"scales.bin has fewer rows than the vectors in {w.dir} "
                    "(corrupt partial shard)"
                )
        if total_rows:
            w._fh = open(w.dir / w.files[-1]["name"], "ab")
            w._rows_in_file = w.files[-1]["rows"]
        w.count = total_rows
        w._docids = list(existing)
        w._derived = [f"{d}#{w.lang}" if w.lang else d for d in existing]
        return w, set(existing)

    def _open_new_file(self):
        name = f"emb.{len(self.files):05d}.bin"
        self.files.append({"name": name, "rows": 0})
        self._fh = open(self.dir / name, "wb")
        self._rows_in_file = 0

    def append(
        self,
        vecs,
        docids: Sequence[str],
        derived_ids: Optional[Sequence[str]] = None,
    ) -> None:
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(f"rows of shape {tuple(vecs.shape)} do not match dim {self.dim}")
        if len(docids) != len(vecs):
            raise ValueError(f"{len(docids)} docids for {len(vecs)} rows")
        with timing.span("store.append"):
            # sidecars first, then rows: resume_partial trusts the row count
            with open(self.dir / "docids.partial.txt", "a", encoding="utf-8") as fh:
                fh.write("".join(f"{d}\n" for d in docids))
            rows, scales = to_storage(vecs, self.dtype_name)
            if scales is not None:
                with open(self.dir / "scales.bin", "ab") as fh:
                    fh.write(np.ascontiguousarray(scales, np.float32).tobytes())
            pos = 0
            while pos < len(rows):
                if self._fh is None or self._rows_in_file >= self.rows_per_file:
                    if self._fh is not None:
                        self._fh.close()
                    self._open_new_file()
                take = min(len(rows) - pos, self.rows_per_file - self._rows_in_file)
                self._fh.write(rows[pos : pos + take].tobytes())
                self._rows_in_file += take
                self.files[-1]["rows"] = self._rows_in_file
                pos += take
            self._fh.flush()
            self._docids.extend(str(d) for d in docids)
            src = derived_ids if derived_ids is not None else docids
            self._derived.extend(str(d) for d in src)
            self.count += len(rows)
        timing.count("store.rows", len(rows))

    def finalize(self, extra: Optional[Dict] = None) -> ShardManifest:
        with timing.span("store.finalize"):
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            (self.dir / "docids.txt").write_text("\n".join(self._docids), encoding="utf-8")
            with open(self.dir / "docid_map.tsv", "w", encoding="utf-8") as fh:
                print("int_id\tderived_id\tbase_id\tlang", file=fh)
                for i, (derived, base) in enumerate(zip(self._derived, self._docids)):
                    print(f"{i}\t{derived}\t{base}\t{self.lang or ''}", file=fh)
            manifest = ShardManifest(
                dim=self.dim,
                dtype=self.dtype_name,
                count=self.count,
                files=self.files,
                lang=self.lang,
                encoder=self.encoder,
                normalized=self.normalized,
                extra=extra or {},
            )
            tmp = self.dir / "manifest.json.tmp"
            tmp.write_text(manifest.to_json(), encoding="utf-8")
            tmp.replace(self.dir / "manifest.json")
            partial = self.dir / "docids.partial.txt"
            if partial.exists():
                partial.unlink()
            return manifest


class ShardStore:
    """Reader over a finalized shard directory (or an in-memory build)."""

    def __init__(
        self,
        manifest: ShardManifest,
        vectors: np.ndarray,
        docids: List[str],
        derived_ids: Optional[List[str]] = None,
        directory: Optional[pathlib.Path] = None,
        scales: Optional[np.ndarray] = None,
    ) -> None:
        self.manifest = manifest
        self.vectors = vectors  # (count, dim) host storage array, maybe a memmap
        self.docids = docids
        self.derived_ids = derived_ids if derived_ids is not None else docids
        self.dir = directory
        self.scales = scales  # per-row f32 scales (int8 storage only)

    @property
    def count(self) -> int:
        return self.manifest.count

    @property
    def dim(self) -> int:
        return self.manifest.dim

    @classmethod
    def exists(cls, directory: PathLike) -> bool:
        return (pathlib.Path(directory) / "manifest.json").exists()

    @property
    def torch_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.manifest.dtype]

    def rows(self, start: int = 0, stop: Optional[int] = None) -> torch.Tensor:
        """Rows ``[start, stop)`` as a CPU tensor of the storage dtype."""
        return storage_to_tensor(self.vectors[start:stop], self.manifest.dtype)

    @classmethod
    def open(cls, directory: PathLike, *, concat_parts: bool = True) -> "ShardStore":
        """Open a finalized store; a one-file store stays memory-mapped, a
        multi-file one is concatenated into one host array unless
        ``concat_parts=False``: ``vectors`` is then None and the caller reads
        through its own per-file maps (as the token store does)."""
        d = pathlib.Path(directory)
        manifest = ShardManifest.from_json((d / "manifest.json").read_text())
        dtype = storage_dtype(manifest.dtype)
        parts = []
        for f in manifest.files:
            parts.append(np.memmap(d / f["name"], dtype=dtype, mode="r",
                                   shape=(f["rows"], manifest.dim)))
        if len(parts) == 1:
            vectors = parts[0]
        elif not parts:
            vectors = np.zeros((0, manifest.dim), dtype)
        elif concat_parts:
            vectors = np.concatenate([np.asarray(p) for p in parts], axis=0)
        else:
            vectors = None
        n_stored = sum(p.shape[0] for p in parts)
        if n_stored != manifest.count:
            raise ValueError(
                f"manifest count {manifest.count} != stored rows {n_stored} in {d}"
            )
        docids = (d / "docids.txt").read_text(encoding="utf-8").splitlines()
        derived: Optional[List[str]] = None
        map_path = d / "docid_map.tsv"
        if map_path.exists():
            derived = []
            with open(map_path, encoding="utf-8") as fh:
                next(fh)  # header
                for line in fh:
                    fields = line.rstrip("\n").split("\t")
                    if len(fields) >= 2:
                        derived.append(fields[1])
        scales = None
        if manifest.dtype == "int8" and (d / "scales.bin").exists():
            scales = np.fromfile(d / "scales.bin", dtype=np.float32)
            if scales.shape[0] != manifest.count:
                raise ValueError(
                    f"scales count {scales.shape[0]} != manifest count {manifest.count} in {d}"
                )
        return cls(manifest, vectors, docids, derived, directory=d, scales=scales)

    @classmethod
    def build(
        cls,
        vectors,
        docids: Sequence[str],
        *,
        dtype: str = "bfloat16",
        lang: Optional[str] = None,
        encoder: Optional[str] = None,
        normalized: bool = True,
        derived_ids: Optional[Sequence[str]] = None,
        scales: Optional[np.ndarray] = None,
    ) -> "ShardStore":
        """In-memory store (no directory) from rows (numpy or torch). Float
        rows with ``dtype="int8"`` are quantized per row; rows that are
        already int8 take their f32 ``scales``."""
        rows, quant_scales = to_storage(vectors, dtype)
        if quant_scales is not None:
            scales = quant_scales
        elif scales is not None:
            scales = np.ascontiguousarray(scales, np.float32)
            if dtype != "int8" or scales.shape != (rows.shape[0],):
                raise ValueError(f"scales of shape {scales.shape} for {rows.shape[0]} {dtype} rows")
        manifest = ShardManifest(
            dim=rows.shape[1], dtype=dtype, count=rows.shape[0], files=[],
            lang=lang, encoder=encoder, normalized=normalized,
        )
        return cls(manifest, rows, list(map(str, docids)),
                   list(map(str, derived_ids)) if derived_ids is not None else None,
                   scales=scales)

    def save(self, directory: PathLike, rows_per_file: int = 1_000_000) -> "ShardStore":
        w = ShardWriter(
            directory, self.dim, self.manifest.dtype, lang=self.manifest.lang,
            encoder=self.manifest.encoder, normalized=self.manifest.normalized,
            rows_per_file=rows_per_file,
        )
        step = max(1, min(rows_per_file, 262_144))
        for start in range(0, self.count, step):
            stop = min(start + step, self.count)
            w.append(
                self.rows(start, stop),
                self.docids[start:stop],
                self.derived_ids[start:stop],
            )
        if self.manifest.dtype == "int8" and self.scales is not None:
            np.ascontiguousarray(self.scales, np.float32).tofile(
                pathlib.Path(directory) / "scales.bin"
            )
        w.finalize(extra=self.manifest.extra)
        return ShardStore.open(directory)


class ConcatStore(ShardStore):
    """Shard stores joined end to end with no host copy of their rows:
    :meth:`rows` reads across the parts' own (memory-mapped or in-memory)
    arrays, so uploading the joined store moves the same bytes as uploading
    each part. It has no ``vectors`` array: that would be a host copy of
    the whole hub."""

    def __init__(
        self,
        manifest: ShardManifest,
        parts: Sequence[ShardStore],
        docids: List[str],
        derived_ids: List[str],
        scales: Optional[np.ndarray] = None,
    ) -> None:
        self.manifest = manifest
        self.parts = list(parts)
        self.docids = docids
        self.derived_ids = derived_ids
        self.dir = None
        self.scales = scales
        self._starts = np.cumsum([0] + [p.count for p in self.parts])

    @property
    def vectors(self) -> np.ndarray:
        raise AttributeError("a ConcatStore keeps its rows in its parts; read them with rows(start, stop)")

    def rows(self, start: int = 0, stop: Optional[int] = None) -> torch.Tensor:
        stop = self.count if stop is None else min(stop, self.count)
        pieces = []
        for i, part in enumerate(self.parts):
            lo, hi = max(start, int(self._starts[i])), min(stop, int(self._starts[i + 1]))
            if lo < hi:
                pieces.append(part.rows(lo - int(self._starts[i]), hi - int(self._starts[i])))
        if not pieces:
            return storage_to_tensor(np.zeros((0, self.dim), storage_dtype(self.manifest.dtype)),
                                     self.manifest.dtype)
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def concat_stores(
    stores: Sequence[ShardStore],
    lang_tags: Optional[Sequence[str]] = None,
) -> ShardStore:
    """The bilingual (or any combined) store: ``stores`` end to end, with
    derived ids ``base#lang``; ``lang`` is ``"+".join(lang_tags)`` and an
    int8 store's scales are concatenated. Rows stay in their parts
    (:class:`ConcatStore`)."""
    assert stores
    dim = stores[0].dim
    dtype = stores[0].manifest.dtype
    for s in stores[1:]:
        if s.dim != dim:
            raise ValueError(f"dim mismatch {s.dim} != {dim}")
        if s.manifest.dtype != dtype:
            raise ValueError(f"dtype mismatch {s.manifest.dtype} != {dtype}")
    if lang_tags is None:
        lang_tags = [s.manifest.lang or str(i) for i, s in enumerate(stores)]
    docids: List[str] = []
    derived: List[str] = []
    for s, tag in zip(stores, lang_tags):
        docids.extend(s.docids)
        derived.extend(f"{d}#{tag}" for d in s.docids)
    manifest = ShardManifest(
        dim=dim, dtype=dtype, count=len(docids), files=[],
        lang="+".join(lang_tags),
        encoder=stores[0].manifest.encoder,
        normalized=all(s.manifest.normalized for s in stores),
    )
    scales = None
    if dtype == "int8" and all(s.scales is not None for s in stores):
        scales = np.concatenate([s.scales for s in stores])
    return ConcatStore(manifest, stores, docids, derived, scales=scales)
