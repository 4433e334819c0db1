"""Corpus streaming, subset selection, and the encode + index builder.

- streaming sources: a ``docid \\t text`` TSV file, HF ``datasets``
  (imported lazily), or deterministic synthetic passages;
- the selection semantics of the JAX package: in subset mode the first
  language keeps every relevant docid and samples non-relevant ones with
  probability ``neg_prob`` until ``subset_neg_cap`` negatives are kept
  (stopping early once the cap is hit and every relevant docid was seen);
  every later language mirrors the first language's selected docid set;
- one :class:`~codemix_dense_retrieval_torch.io.shards.ShardStore` per
  language (bf16, f32, f16 or int8 with ``scales.bin``), skipped when its
  manifest exists (whole-language resume) and reopened after the rows
  already on disk when it does not (mid-language resume);
- with ``tokens_per_doc > 0``, a per-language token store at
  ``<lang>/tokens`` for the two-stage MaxSim rerank, written from the same
  backbone pass as the dense rows; each store resumes on its own, and a
  language whose dense store is finished gets its token store backfilled;
- the root ``docids.txt`` and ``meta.json``;
- ``pack=True``: sequence-packed encode (short passages share device rows,
  :meth:`~codemix_dense_retrieval_torch.models.encoder.TextEncoder.encode_documents`).
"""

from __future__ import annotations

import json
import pathlib
import random
import shutil
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

import torch

from codemix_dense_retrieval_torch.io.shards import ShardStore, ShardWriter
from codemix_dense_retrieval_torch.io.token_shards import TokenShardStore, TokenShardWriter
from codemix_dense_retrieval_torch.utils.logging import get_logger

log = get_logger("corpus")

Doc = Tuple[str, str]  # (docid, text)


class TsvCorpusSource:
    """``docid \\t text`` file source."""

    def __init__(self, path, lang: Optional[str] = None) -> None:
        self.path = pathlib.Path(path)
        self.lang = lang

    def __iter__(self) -> Iterator[Doc]:
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                parts = line.split("\t", 1)
                if len(parts) == 2 and parts[1]:
                    yield parts[0], parts[1]


class HFCorpusSource:
    """HF datasets streaming source (mMARCO ``collection-<lang>``). Needs the
    ``datasets`` package and access to the dataset; raises a clear error
    without the package."""

    def __init__(
        self,
        repo: str,
        config: str,
        split: str = "collection",
        id_field: str = "id",
        text_field: str = "text",
    ) -> None:
        self.repo, self.config, self.split = repo, config, split
        self.id_field, self.text_field = id_field, text_field

    def __iter__(self) -> Iterator[Doc]:
        try:
            from datasets import load_dataset
        except ImportError as e:
            raise RuntimeError(
                f"HFCorpusSource({self.repo!r}) needs the `datasets` package, which is not "
                "installed; export the collection to a `docid<TAB>text` TSV and pass "
                "--corpus_tsv LANG=PATH instead"
            ) from e
        ds = load_dataset(self.repo, self.config, split=self.split, streaming=True)
        for x in ds:
            text = x.get(self.text_field, "")
            if text:
                yield str(x[self.id_field]), text


class SyntheticCorpusSource:
    """Deterministic synthetic passages (tests/benchmarks)."""

    def __init__(self, n: int, lang: str = "en", seed: int = 0) -> None:
        self.n, self.lang, self.seed = n, lang, seed

    def __iter__(self) -> Iterator[Doc]:
        rng = random.Random(self.seed)
        words = [f"w{i}" for i in range(500)]
        for i in range(self.n):
            text = " ".join(rng.choice(words) for _ in range(rng.randint(5, 30)))
            yield str(i), f"[{self.lang}] {text}"


@dataclass
class SelectionState:
    """First-language selection state shared across languages (mirror)."""

    rel_ids: Set[str]
    subset_neg_cap: int = 0
    neg_prob: float = 1.0
    seed: int = 42
    selected: Set[str] = field(default_factory=set)
    neg_kept: int = 0
    _rng: random.Random = field(default=None, repr=False)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)

    @property
    def subset_mode(self) -> bool:
        return bool(self.subset_neg_cap)

    def select_first_lang(self, docid: str) -> bool:
        """Relevant docids always kept; negatives sampled up to the cap."""
        if not self.subset_mode:
            self.selected.add(docid)
            return True
        if docid in self.rel_ids:
            self.selected.add(docid)
            return True
        if self.neg_kept < self.subset_neg_cap and self._rng.random() < self.neg_prob:
            if docid not in self.selected:
                self.selected.add(docid)
                self.neg_kept += 1
            return True
        return False

    def first_lang_done(self, seen_rel: Set[str]) -> bool:
        """Early stop: negative cap reached and all relevants captured."""
        return (
            self.subset_mode
            and self.neg_kept >= self.subset_neg_cap
            and seen_rel >= self.rel_ids
        )

    def select_mirror(self, docid: str) -> bool:
        return docid in self.selected


_STORE_FILES = ("manifest.json", "docids.txt", "docids.partial.txt", "docid_map.tsv", "scales.bin")


def _batched(it: Iterable, n: int) -> Iterator[List]:
    buf: List = []
    for x in it:
        buf.append(x)
        if len(buf) == n:
            yield buf
            buf = []
    if buf:
        yield buf


def _backfill_tokens(
    encoder,
    source: Iterable[Doc],
    lang: str,
    lang_dir: pathlib.Path,
    existing: ShardStore,
    tokens_per_doc: int,
    token_dtype: str,
    batch_size: int,
    enc_batch: int,
) -> None:
    """Token store for a language whose dense store is already finished: a
    token-only encode pass over exactly the docids the store kept."""
    log.info("backfilling token store for already-indexed language %s", lang)
    wanted = set(existing.docids)
    tok_writer, tok_written = TokenShardWriter.resume_partial(
        lang_dir / "tokens", token_dim=encoder.dim, tokens_per_doc=tokens_per_doc,
        dtype=token_dtype, lang=lang, encoder=getattr(encoder, "name", None),
    )
    done = len(tok_written)
    for batch in _batched(iter(source), batch_size):
        if done >= len(wanted):
            break
        keep = [(d, t) for d, t in batch if d in wanted and d not in tok_written]
        if not keep:
            continue
        ids = [d for d, _ in keep]
        toks, lens = encoder.encode_documents_tokens(
            [t for _, t in keep], batch_size=enc_batch, max_tokens=tokens_per_doc
        )
        tok_writer.append(toks, lens, ids, [f"{d}#{lang}" for d in ids])
        tok_written.update(ids)
        done += len(ids)
    tok_writer.finalize()
    # the backfill rebuilds the row order by re-reading the source: any
    # drift or duplicate docid would desync its rows from the dense store
    built = TokenShardStore.open(lang_dir / "tokens")
    if list(built.docids) != list(existing.docids):
        raise RuntimeError(
            f"token-store backfill for {lang} produced a docid order that does not match "
            f"the dense index ({built.count} vs {existing.count} rows): the source stream "
            "changed since the index was built; re-encode with --force"
        )


def encode_corpus(
    encoder,
    sources: Dict[str, Iterable[Doc]],
    out_root,
    *,
    selection: Optional[SelectionState] = None,
    batch_size: int = 256,
    enc_batch: int = 64,
    max_docs: int = 0,
    storage_dtype: str = "bfloat16",
    force: bool = False,
    tokens_per_doc: int = 0,
    token_dtype: str = "int8",
    pack: bool = False,
) -> Dict[str, pathlib.Path]:
    """Encode per-language corpora into ShardStore directories.

    ``sources`` maps language code -> doc stream; the FIRST entry drives
    selection, later ones mirror it. Languages whose manifest already exists
    are skipped (resume); an unfinalized language directory is reopened
    after the rows already written. Returns {lang: shard_dir}.

    ``tokens_per_doc > 0`` also writes a
    :class:`~codemix_dense_retrieval_torch.io.token_shards.TokenShardStore`
    (``token_dtype``) at ``<lang>/tokens``: one backbone pass gives the
    dense row and the token block. Each store skips only its own rows
    already written, so a crash between the two appends heals on restart."""
    out_root = pathlib.Path(out_root)
    out_root.mkdir(parents=True, exist_ok=True)
    selection = selection or SelectionState(rel_ids=set())
    results: Dict[str, pathlib.Path] = {}
    base_ids_global: Set[str] = set()
    started = time.strftime("%Y-%m-%d %H:%M:%S")
    # bf16 stores never see the f32 mantissa: cast on the device before the copy
    readback = torch.bfloat16 if storage_dtype == "bfloat16" else None

    for lang_idx, (lang, source) in enumerate(sources.items()):
        lang_dir = out_root / lang
        results[lang] = lang_dir
        if not force and ShardStore.exists(lang_dir):
            log.info("language %s already indexed; skipping (resume)", lang)
            existing = ShardStore.open(lang_dir)
            if lang_idx == 0:
                # rebuild the selection state from the finished language
                selection.selected.update(existing.docids)
                selection.neg_kept += sum(
                    1 for d in existing.docids if d not in selection.rel_ids
                )
            base_ids_global.update(existing.docids)
            if tokens_per_doc and not TokenShardStore.exists(lang_dir / "tokens"):
                _backfill_tokens(
                    encoder, source, lang, lang_dir, existing,
                    tokens_per_doc, token_dtype, batch_size, enc_batch,
                )
            elif tokens_per_doc:
                tok_existing = TokenShardStore.open(lang_dir / "tokens")
                if tok_existing.count != existing.count:
                    raise ValueError(
                        f"token store for {lang} is finalized with {tok_existing.count} rows "
                        f"but the dense index has {existing.count}; delete "
                        f"{lang_dir / 'tokens'} and re-run to rebuild it"
                    )
            continue

        if force:
            # a forced re-encode starts the store afresh: resuming would count
            # the old rows while the finished store's docid sidecar is gone
            for f in lang_dir.glob("*"):
                if f.is_file() and (f.name in _STORE_FILES or f.name.startswith("emb.")):
                    f.unlink()
            shutil.rmtree(lang_dir / "tokens", ignore_errors=True)
        # mid-language resume: reopen partial shard files and skip docids
        # already encoded (selection is deterministic under the same seed
        # and stream order, so replaying it reproduces the same keep-set)
        writer, already_written = ShardWriter.resume_partial(
            lang_dir,
            dim=encoder.dim,
            dtype=storage_dtype,
            lang=lang,
            encoder=getattr(encoder, "name", None),
        )
        if already_written:
            log.info(
                "resuming language %s mid-encode: %d vectors already on disk",
                lang, len(already_written),
            )
            base_ids_global.update(already_written)
        tok_writer = None
        tok_written: Set[str] = set()
        if tokens_per_doc:
            tok_writer, tok_written = TokenShardWriter.resume_partial(
                lang_dir / "tokens", token_dim=encoder.dim, tokens_per_doc=tokens_per_doc,
                dtype=token_dtype, lang=lang, encoder=getattr(encoder, "name", None),
            )
        seen_rel: Set[str] = set()
        kept = writer.count

        def tok_lagging() -> bool:
            # after a crash between the dense and the token append the token
            # store is short of the dense one: every "dense looks done" stop
            # keeps scanning until the token side has caught up
            return tok_writer is not None and tok_writer.count < writer.count

        for batch in _batched(iter(source), batch_size):
            if lang_idx == 0 and selection.first_lang_done(seen_rel) and not tok_lagging():
                break
            if (lang_idx > 0 and selection.subset_mode and kept >= len(selection.selected)
                    and not tok_lagging()):
                break
            keep_ids: List[str] = []
            keep_texts: List[str] = []
            new_dense = 0
            for docid, text in batch:
                if lang_idx == 0:
                    ok = selection.select_first_lang(docid)
                    if ok and docid in selection.rel_ids:
                        seen_rel.add(docid)
                else:
                    ok = selection.select_mirror(docid)
                if not ok:
                    continue
                need_dense = docid not in already_written
                if max_docs and need_dense and kept + new_dense >= max_docs:
                    # past the dense cap; token catch-up rows are docids
                    # already in the dense store, which fills in stream
                    # order, so none lies past this point
                    break
                need_tok = tok_writer is not None and docid not in tok_written
                if need_dense or need_tok:
                    keep_ids.append(docid)
                    keep_texts.append(text)
                    new_dense += need_dense
            if not keep_ids:
                if max_docs and kept >= max_docs and not tok_lagging():
                    break
                continue
            if tok_writer is None:
                vecs = encoder.encode_documents(keep_texts, batch_size=enc_batch, readback_dtype=readback, pack=pack)
                toks = lens = None
            else:
                vecs, toks, lens = encoder.encode_documents_with_tokens(
                    keep_texts, batch_size=enc_batch, max_tokens=tokens_per_doc, pack=pack
                )
            # each store skips only its own rows already written
            dense_new = [i for i, d in enumerate(keep_ids) if d not in already_written]
            if dense_new:
                ids_n = [keep_ids[i] for i in dense_new]
                writer.append(vecs[dense_new], ids_n, [f"{d}#{lang}" for d in ids_n])
                kept += len(ids_n)
                base_ids_global.update(ids_n)
            if tok_writer is not None:
                tok_new = [i for i, d in enumerate(keep_ids) if d not in tok_written]
                if tok_new:
                    ids_t = [keep_ids[i] for i in tok_new]
                    tok_writer.append(toks[tok_new], lens[tok_new], ids_t, [f"{d}#{lang}" for d in ids_t])
            if max_docs and kept >= max_docs and not tok_lagging():
                break
        writer.finalize(
            extra={
                "subset_mode": selection.subset_mode,
                "neg_kept": selection.neg_kept,
                "rel_ids": len(selection.rel_ids),
            }
        )
        if tok_writer is not None:
            tok_writer.finalize()
        log.info("saved %d vectors for language %s -> %s", kept, lang, lang_dir)

    (out_root / "docids.txt").write_text(
        "\n".join(sorted(base_ids_global)), encoding="utf-8"
    )
    meta = {
        "started_at": started,
        "encoder": getattr(encoder, "name", None),
        "dtype": storage_dtype,
        "normalize_embeddings": True,
        "langs": list(sources.keys()),
        "subset_neg_cap": selection.subset_neg_cap,
        "neg_prob": selection.neg_prob,
        "rel_ids": len(selection.rel_ids),
        "saved_dir": str(out_root),
        "dimension": encoder.dim,
        "tokens_per_doc": tokens_per_doc,
        "token_dtype": token_dtype if tokens_per_doc else None,
        "indexes": [
            {"lang": lang, "path": str(path)} for lang, path in results.items()
        ],
    }
    (out_root / "meta.json").write_text(json.dumps(meta, indent=2), encoding="utf-8")
    return results
