"""Token-level embedding store for multi-vector (late-interaction) serving:
the two-stage path recalls candidates from the flat index and reranks them
by MaxSim over their token embeddings, gathered from this store.

Layout (the JAX package's, byte for byte, so either package reads the
other's store): each document's token block is one flat row of
``tokens_per_doc * token_dim`` values in an inner shard directory, plus two
sidecars:

    <dir>/...                 inner ShardStore files (emb.*.bin, docids,
                              manifest with extra.kind = "token_store")
    <dir>/lengths.bin         int32 valid-token count per row
    <dir>/token_scales.bin    f32 (count * tokens_per_doc) per-TOKEN
                              symmetric int8 scales (int8 storage only)

Per-token (not per-row) scales keep MaxSim products accurate: one large
token would otherwise coarsen every other token of its document.

Crash-resume follows the dense store: the inner writer cuts torn rows and
the docid sidecar; this wrapper then truncates ``lengths.bin`` and
``token_scales.bin`` to the row count.
"""

from __future__ import annotations

import json
import pathlib
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from codemix_dense_retrieval_torch.io.shards import (
    TORCH_DTYPES,
    PathLike,
    ShardStore,
    ShardWriter,
    storage_dtype,
)
from codemix_dense_retrieval_torch.ops.quant import quantize_rows


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """Raw bf16 bit patterns (uint16) -> the f32 values they encode."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def token_blocks(
    token_embs,              # (n, T, token_dim) f32 tensor (any device) or numpy
    lengths: Sequence[int],  # valid tokens per doc
    tokens_per_doc: int,
    token_dim: int,
    dtype_name: str,
) -> Tuple[np.ndarray, torch.Tensor, Optional[torch.Tensor]]:
    """Token blocks as a store keeps them, made on the tensor's own device (a
    numpy array is a CPU tensor): (lengths (n,) int32 clamped to the kept
    tokens, blocks (n, Td, d) in the stored dtype, per-token scales (n, Td)
    f32 for int8, else None). Each block is cut or zero-padded to
    ``tokens_per_doc`` and zeroed past its length; per-token quantization is
    per-row :func:`~codemix_dense_retrieval_torch.ops.quant.quantize_rows` of
    the (n * Td, d) tokens, bit-identical to the JAX package's numpy
    quantizer. The writer and the two-stage searcher's ``add`` share it."""
    if not isinstance(token_embs, torch.Tensor):
        token_embs = torch.from_numpy(np.asarray(token_embs))
    n, t, d = token_embs.shape
    if d != token_dim:
        raise ValueError(f"token dim {d} != store token_dim {token_dim}")
    td = tokens_per_doc
    # clamp to both the store's Td and the batch's token axis t: a length
    # past t would mark zero-padded slots valid, and a valid all-zero
    # token floors every query token's max at 0
    keep = min(t, td)
    lengths = np.minimum(np.asarray(lengths, np.int32), keep)
    valid = torch.arange(td)[None, :] < torch.from_numpy(lengths)[:, None]
    # tokens past a doc's length are zeroed, so their int8 scales stay
    # exactly 1.0
    block = torch.zeros((n, td, d), dtype=torch.float32, device=token_embs.device)
    block[:, :keep] = token_embs[:, :keep].to(torch.float32)
    block *= valid.to(block.device)[..., None]
    if dtype_name == "int8":
        q, scales = quantize_rows(block.reshape(n * td, d))
        return lengths, q.reshape(n, td, d), scales.reshape(n, td)
    return lengths, block.to(TORCH_DTYPES[dtype_name]), None


class TokenShardWriter:
    """Streaming writer of fixed-``tokens_per_doc`` token blocks."""

    def __init__(
        self,
        out_dir: PathLike,
        token_dim: int,
        tokens_per_doc: int,
        dtype: str = "int8",
        *,
        lang: Optional[str] = None,
        encoder: Optional[str] = None,
        rows_per_file: int = 65_536,
    ) -> None:
        self.token_dim = token_dim
        self.tokens_per_doc = tokens_per_doc
        self.dtype_name = dtype
        self._inner = ShardWriter(
            out_dir,
            tokens_per_doc * token_dim,
            dtype,
            lang=lang,
            encoder=encoder,
            normalized=True,  # per-token L2 (the token_embeddings contract)
            rows_per_file=rows_per_file,
        )
        self.dir = self._inner.dir

    @classmethod
    def resume_partial(
        cls,
        out_dir: PathLike,
        token_dim: int,
        tokens_per_doc: int,
        dtype: str = "int8",
        **kw,
    ) -> Tuple["TokenShardWriter", Set[str]]:
        """Reopen an unfinalized token store after the rows already written;
        returns (writer, docids already written)."""
        w = cls(out_dir, token_dim, tokens_per_doc, dtype, **kw)
        inner, existing = ShardWriter.resume_partial(
            out_dir, tokens_per_doc * token_dim, dtype,
            lang=w._inner.lang, encoder=w._inner.encoder,
            rows_per_file=w._inner.rows_per_file,
        )
        inner.normalized = True
        w._inner = inner
        total = inner.count
        # the sidecars are appended before the rows: cut any run-ahead rows
        for name, itemsize, per_row in (
            ("lengths.bin", 4, 1),
            ("token_scales.bin", 4, tokens_per_doc),
        ):
            path = w.dir / name
            if not path.exists():
                if total and (name != "token_scales.bin" or dtype == "int8"):
                    raise ValueError(f"{name} missing from partial token shard {w.dir}")
                continue
            want = total * per_row * itemsize
            if path.stat().st_size > want:
                with open(path, "r+b") as fh:
                    fh.truncate(want)
            elif path.stat().st_size < want:
                raise ValueError(
                    f"{name} has fewer rows than the vectors in {w.dir} "
                    "(corrupt partial token shard)"
                )
        return w, existing

    @property
    def count(self) -> int:
        return self._inner.count

    def append(
        self,
        token_embs,              # (n, T, token_dim) f32 tensor (any device) or numpy; T may vary per batch
        lengths: Sequence[int],  # valid tokens per doc
        docids: Sequence[str],
        derived_ids: Optional[Sequence[str]] = None,
    ) -> None:
        """Append token blocks. They are padded, masked and quantized on the
        tensor's own device (:func:`token_blocks`), so from the card only the
        stored bytes cross to the host: int8 rows and their scales, or bf16
        rows."""
        lengths, blocks, scales = token_blocks(
            token_embs, lengths, self.tokens_per_doc, self.token_dim, self.dtype_name
        )
        n, td, d = blocks.shape
        with open(self.dir / "lengths.bin", "ab") as fh:
            fh.write(np.ascontiguousarray(lengths, np.int32).tobytes())
        if scales is not None:
            with open(self.dir / "token_scales.bin", "ab") as fh:
                fh.write(scales.cpu().numpy().astype(np.float32, copy=False).tobytes())
        flat = blocks.reshape(n, td * d)  # already in the stored dtype
        self._inner.append(flat, docids, derived_ids)

    def finalize(self, extra=None) -> None:
        meta = dict(extra or {})
        meta.update(kind="token_store", tokens_per_doc=self.tokens_per_doc, token_dim=self.token_dim)
        self._inner.finalize(extra=meta)


class TokenShardStore:
    """Reader: memory-mapped token blocks, gathered on the host by row id."""

    def __init__(
        self,
        inner: ShardStore,
        tokens_per_doc: int,
        token_dim: int,
        lengths: np.ndarray,
        token_scales: Optional[np.ndarray],
        parts: Optional[List[np.ndarray]] = None,
    ) -> None:
        self._inner = inner
        self.tokens_per_doc = tokens_per_doc
        self.token_dim = token_dim
        self.lengths = lengths
        self.token_scales = token_scales  # (count, Td) f32 for int8 stores
        # per-file memmaps + cumulative row offsets: a corpus-scale store
        # spans many files and must stay on disk, so gathers read the parts
        self._parts = parts
        self._part_offsets = None if parts is None else np.cumsum([0] + [p.shape[0] for p in parts])

    @property
    def count(self) -> int:
        return self._inner.count

    @property
    def docids(self) -> List[str]:
        return self._inner.docids

    @property
    def dtype(self) -> str:
        return self._inner.manifest.dtype

    @classmethod
    def exists(cls, directory: PathLike) -> bool:
        if not ShardStore.exists(directory):
            return False
        m = json.loads((pathlib.Path(directory) / "manifest.json").read_text())
        return m.get("extra", {}).get("kind") == "token_store"

    @classmethod
    def open(cls, directory: PathLike, *, mmap: bool = True) -> "TokenShardStore":
        """Open a finalized token store; with ``mmap`` (the default) a
        multi-file store stays on disk and every gather reads its per-file
        maps, without it the blocks are read into RAM."""
        directory = pathlib.Path(directory)
        inner = ShardStore.open(directory, concat_parts=not mmap)
        extra = inner.manifest.extra
        if extra.get("kind") != "token_store":
            raise ValueError(f"{directory} is not a token shard store")
        parts = None
        if mmap and len(inner.manifest.files) > 1:
            dtype = storage_dtype(inner.manifest.dtype)
            parts = [
                np.memmap(directory / f["name"], dtype=dtype, mode="r", shape=(f["rows"], inner.dim))
                for f in inner.manifest.files
            ]
        elif not mmap:
            inner.vectors = np.asarray(inner.vectors)
        td, d = int(extra["tokens_per_doc"]), int(extra["token_dim"])
        if td * d != inner.dim:
            raise ValueError(f"manifest dim {inner.dim} != tokens_per_doc*token_dim {td * d}")
        lengths = np.fromfile(directory / "lengths.bin", dtype=np.int32)
        if lengths.shape[0] != inner.count:
            raise ValueError(f"lengths count {lengths.shape[0]} != manifest count {inner.count}")
        scales = None
        if inner.manifest.dtype == "int8":
            scales = np.memmap(directory / "token_scales.bin", dtype=np.float32, mode="r")
            if scales.shape[0] != inner.count * td:
                raise ValueError(
                    f"token_scales count {scales.shape[0]} != count*Td {inner.count * td}"
                )
            scales = scales.reshape(inner.count, td)
        return cls(inner, td, d, lengths, scales, parts=parts)

    # ---------------- gather ----------------

    def gather_quantized(
        self, rows: np.ndarray
    ) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
        """Stored blocks of the given row ids: (tokens (n, Td, d) in the
        host storage dtype (bf16 as raw uint16 bits), per-token scales
        (n, Td) or None, mask (n, Td) int32). The fancy index touches only
        the candidates' pages of the maps."""
        rows = np.asarray(rows, np.int64)
        if self._parts is not None:
            flat = np.empty((len(rows), self._inner.dim), dtype=self._parts[0].dtype)
            part_of = np.searchsorted(self._part_offsets, rows, side="right") - 1
            for p in np.unique(part_of):
                sel = part_of == p
                flat[sel] = self._parts[p][rows[sel] - self._part_offsets[p]]
        else:
            flat = np.asarray(self._inner.vectors[rows])
        toks = flat.reshape(len(rows), self.tokens_per_doc, self.token_dim)
        scales = None if self.token_scales is None else np.asarray(self.token_scales[rows])
        mask = (np.arange(self.tokens_per_doc)[None, :] < self.lengths[rows][:, None]).astype(np.int32)
        return toks, scales, mask

    def gather(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Dequantized f32 token blocks: (tokens (n, Td, d) f32, mask)."""
        toks, scales, mask = self.gather_quantized(rows)
        toks = _bf16_bits_to_f32(toks) if self.dtype == "bfloat16" else np.asarray(toks, np.float32)
        if scales is not None:
            toks = toks * scales[..., None]
        return toks, mask
