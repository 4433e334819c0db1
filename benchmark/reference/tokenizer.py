"""The tokenizer stand-ins, as plain Python.

The benchmark's texts are words of a seeded word-level vocabulary joined by
single spaces, so a word-level tokenizer with a whitespace pre-tokenizer
maps each word to its vocabulary id and the family's template adds the
special tokens: XLM-R's ``<s> ... </s>``, Qwen3's ``... <|endoftext|>``.
:func:`hash_ids` is the hashing stand-in (blake2b of each ``\\w+`` or
punctuation run, XLM-R's bos / eos around the words), for machines where
the ``tokenizers`` package is missing.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, List, Sequence

_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


def word_level_ids(text: str, vocab: Dict[str, int], prefix: Sequence[int],
                   suffix: Sequence[int], unk_id: int) -> List[int]:
    """Ids of ``text``: each whitespace-separated word's vocabulary id (the
    unknown id where it has none) between the template's prefix and suffix
    ids."""
    return [*prefix, *(vocab.get(w, unk_id) for w in text.split()), *suffix]


def hash_ids(text: str, vocab_size: int, bos_id: int = 0, eos_id: int = 2) -> List[int]:
    """The hashing stand-in: ``3 + blake2b-32(word) % (vocab_size - 3)`` for
    each ``\\w+`` run or punctuation mark, between bos and eos."""
    ids = [bos_id]
    for w in _WORD_RE.findall(text):
        h = int.from_bytes(hashlib.blake2b(w.encode(), digest_size=4).digest(), "little")
        ids.append(3 + h % (vocab_size - 3))
    return ids + [eos_id]
