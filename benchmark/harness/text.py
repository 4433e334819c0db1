"""The word-level tokenizer of a configuration and its plain twin.

A configuration's ``tokenizer`` entry lays out its vocabulary of
``vocab_size`` ids: ``words`` [first id, count] are word slots, spelled
``w<hex slot>`` (:func:`harness.data.words_text`), ``specials`` name ids of
their own, every other id gets a filler name; ``prefix`` / ``suffix`` are
the special tokens the family's template puts around a text. ``kind``
``word_level`` writes it as a Hugging Face ``tokenizer.json`` (WordLevel
model, whitespace pre-tokenizer, the template as post-processor) for the
port's ``HFTokenizer``; ``hash`` uses the port's ``HashTokenizer`` instead.
"""

from __future__ import annotations

import json
import pathlib
from typing import Callable, Dict, List

from reference.tokenizer import hash_ids, word_level_ids


def vocab_of(tok: Dict, vocab_size: int) -> Dict[str, int]:
    first, count = tok["words"]
    vocab = {f"w{j:x}": first + j for j in range(count)}
    vocab.update(tok["specials"])
    taken = set(vocab.values())
    for i in range(vocab_size):
        if i not in taken:
            vocab[f"<|unused_{i}|>"] = i
    if len(vocab) != vocab_size or set(vocab.values()) != set(range(vocab_size)):
        raise ValueError("tokenizer layout does not cover the vocabulary exactly once")
    return vocab


def write_tokenizer_json(tok: Dict, vocab_size: int, directory: pathlib.Path) -> pathlib.Path:
    """``<directory>/tokenizer.json`` of the layout (needs ``tokenizers``)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    vocab = vocab_of(tok, vocab_size)
    t = Tokenizer(models.WordLevel(vocab, unk_token=tok["unk"]))
    t.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    single = " ".join([*tok["prefix"], "$A", *tok["suffix"]])
    specials = [(s, vocab[s]) for s in dict.fromkeys([*tok["prefix"], *tok["suffix"]])]
    t.post_processor = processors.TemplateProcessing(single=single, special_tokens=specials)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / "tokenizer.json"
    t.save(str(path))
    return path


def reference_tokenizer(tok: Dict, vocab_size: int) -> Callable[[str], List[int]]:
    """The plain twin of the configuration's tokenizer: text -> ids."""
    if tok["kind"] == "hash":
        return lambda text: hash_ids(text, vocab_size)
    vocab = vocab_of(tok, vocab_size)
    prefix = [vocab[s] for s in tok["prefix"]]
    suffix = [vocab[s] for s in tok["suffix"]]
    unk = vocab[tok["unk"]]
    return lambda text: word_level_ids(text, vocab, prefix, suffix, unk)


def port_tokenizer(tok: Dict, vocab_size: int, max_length: int, directory: pathlib.Path):
    """The port's tokenizer object for the layout, through the port's own
    loader (``HFTokenizer`` when a ``tokenizer.json`` is there)."""
    from codemix_dense_retrieval_torch.models.tokenizer import HashTokenizer, load_tokenizer

    if tok["kind"] == "hash":
        return HashTokenizer(vocab_size=vocab_size, max_length=max_length)
    write_tokenizer_json(tok, vocab_size, directory)
    return load_tokenizer(directory, max_length, vocab_size=vocab_size)


def special_count(tok: Dict) -> int:
    """Tokens the template adds to every text."""
    return 2 if tok["kind"] == "hash" else len(tok["prefix"]) + len(tok["suffix"])
