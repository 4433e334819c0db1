"""Tokenization layer.

Two backends behind one interface, both producing right-padded
``(input_ids, attention_mask)`` int32 batches (the contiguous-prefix mask
the attention path expects):

- :class:`HFTokenizer` wraps a ``tokenizers`` fast tokenizer loaded from a
  local ``tokenizer.json`` (no network);
- :class:`HashTokenizer` is a deterministic hashing tokenizer with XLM-R's
  special-token layout (bos=0, pad=1, eos=2) for synthetic corpora, tests and
  smoke runs; its ids equal the JAX package's for the same text.
"""

from __future__ import annotations

import hashlib
import pathlib
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512)


class HashTokenizer:
    """Deterministic, vocabulary-free tokenizer (XLM-R special-token ids)."""

    bos_id = 0
    pad_id = 1
    eos_id = 2

    def __init__(self, vocab_size: int = 250_002, max_length: int = 512) -> None:
        self.vocab_size = vocab_size
        self.max_length = max_length
        self._word_re = re.compile(r"\w+|[^\w\s]", re.UNICODE)

    def _token_id(self, word: str) -> int:
        h = int.from_bytes(hashlib.blake2b(word.encode(), digest_size=4).digest(), "little")
        return 3 + (h % (self.vocab_size - 3))

    def encode_batch(
        self, texts: Sequence[str], max_length: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        ml = max_length or self.max_length
        rows = []
        for t in texts:
            ids = [self.bos_id] + [self._token_id(w) for w in self._word_re.findall(t)]
            ids = ids[: ml - 1] + [self.eos_id]
            rows.append(ids)
        return _pad(rows, self.pad_id, ml)


class HFTokenizer:
    """Fast-tokenizer wrapper (local tokenizer.json, offline)."""

    def __init__(self, tokenizer, pad_id: int = 1) -> None:
        self.tokenizer = tokenizer
        self.pad_id = pad_id

    @classmethod
    def from_dir(cls, directory) -> "HFTokenizer":
        from tokenizers import Tokenizer

        path = pathlib.Path(directory) / "tokenizer.json"
        tok = Tokenizer.from_file(str(path))
        pad_id = tok.token_to_id("<pad>")
        if pad_id is None:
            pad_id = 1
        return cls(tok, pad_id)

    def encode_batch(
        self, texts: Sequence[str], max_length: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        # truncate inside the tokenizer so post-processor special tokens
        # (</s>) survive on over-length texts
        if max_length is not None:
            self.tokenizer.enable_truncation(max_length)
        try:
            encs = self.tokenizer.encode_batch(list(texts))
        finally:
            if max_length is not None:
                self.tokenizer.no_truncation()
        rows = [e.ids for e in encs]
        return _pad(rows, self.pad_id, max_length)


def _pad(
    rows: List[List[int]], pad_id: int, max_length: Optional[int]
) -> Tuple[np.ndarray, np.ndarray]:
    longest = max((len(r) for r in rows), default=1)
    if max_length is not None:
        longest = min(longest, max_length)
    longest = max(longest, 1)
    ids = np.full((len(rows), longest), pad_id, dtype=np.int32)
    mask = np.zeros((len(rows), longest), dtype=np.int32)
    for i, r in enumerate(rows):
        r = r[:longest]
        ids[i, : len(r)] = r
        mask[i, : len(r)] = 1
    return ids, mask


def bucket_length(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Round a batch's max length up to a fixed bucket (the longest bucket
    caps it), so batches share a few shapes."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def load_tokenizer(name_or_dir, max_length: int = 512, vocab_size: int = 250_002):
    """HFTokenizer when a local tokenizer.json exists, else a HashTokenizer
    bounded by the model's vocab."""
    if name_or_dir:
        d = pathlib.Path(str(name_or_dir))
        if (d / "tokenizer.json").exists():
            return HFTokenizer.from_dir(d)
    return HashTokenizer(vocab_size=vocab_size, max_length=max_length)
