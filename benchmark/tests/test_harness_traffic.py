"""The traffic generators: the same inputs for the same seed, and the same
work (sizes, lengths) for every seed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import tiny_cell

SEEDS = (2**31 + 5, 2**33 + 11)


def test_index_rows_and_query_pairs_repeat_for_a_seed():
    from harness import data

    for seed in SEEDS:
        a1, b1 = data.query_pairs(50, 32, 0.5, seed, "cpu")
        a2, b2 = data.query_pairs(50, 32, 0.5, seed, "cpu")
        assert torch.equal(a1, a2) and torch.equal(b1, b2)
        pos, rows = data.planted_rows(a1, 300_000, 0.5, seed, "cpu")
        r1 = data.IndexRows(300_000, 32, seed, "cpu", planted_pos=pos, planted_rows=rows)
        r2 = data.IndexRows(300_000, 32, seed, "cpu", planted_pos=pos, planted_rows=rows)
        assert torch.equal(r1(0, 300_000), r2(0, 300_000))
        # any range made alone equals the same range of the whole
        assert torch.equal(r1(262_000, 263_000), r1.host()[262_000:263_000])
        assert torch.equal(r1(0, 300_000)[pos], rows.to(torch.bfloat16))
    other = data.query_pairs(50, 32, 0.5, SEEDS[0] + 1, "cpu")[0]
    assert not torch.equal(other, data.query_pairs(50, 32, 0.5, SEEDS[0], "cpu")[0])


def test_lengths_are_the_same_multiset_for_every_seed():
    from harness import data

    lengths = data.quantile_lengths(4096, 70, 80, 16, 512)
    assert lengths.min() >= 16 and lengths.max() <= 512
    assert 65 <= np.median(lengths) <= 75 and 75 <= lengths.mean() <= 85


def test_encode_pool_and_pass_orders_repeat_for_a_seed(tmp_path):
    from harness import data, text

    cell = tiny_cell("bge-m3.encode-corpus")
    drv = cell.driver
    tok = cell.config["tokenizer"]
    pools = []
    for seed in (SEEDS[0], SEEDS[0], SEEDS[1]):
        t = cell.traffic
        lengths = data.quantile_lengths(t["pool"], t["length"]["median"], t["length"]["mean"],
                                        t["length"]["lo"], t["length"]["hi"])
        rng = data.np_rng(seed, "pool")
        n_words = rng.permutation(lengths) - text.special_count(tok)
        pools.append(data.texts_of_lengths(n_words, tok["words"][1], rng))
    assert pools[0] == pools[1] and pools[0] != pools[2]
    assert sorted(len(p.split()) for p in pools[0]) == sorted(len(p.split()) for p in pools[2])
    s1 = drv.PoolStream(pools[0], SEEDS[0], None)
    s2 = drv.PoolStream(pools[0], SEEDS[0], None)
    assert (s1.order(3) == s2.order(3)).all() and not (s1.order(3) == s1.order(4)).all()


def test_tokenizer_file_matches_its_plain_twin(tmp_path):
    pytest.importorskip("tokenizers")
    from harness import text
    from reference.tokenizer import hash_ids

    from codemix_dense_retrieval_torch.models.tokenizer import HashTokenizer

    for name in ("bge-m3.encode-corpus", "qwen3-0.6b.encode-corpus"):
        cell = tiny_cell(name)
        tok, vocab = cell.config["tokenizer"], cell.config["model"]["vocab_size"]
        port = text.port_tokenizer(tok, vocab, 512, tmp_path / name)
        ref = text.reference_tokenizer(tok, vocab)
        texts = ["w0 w1 w2", "w3e5 w1", " ".join(f"w{j:x}" for j in range(60))]
        ids, mask = port.encode_batch(texts, 512)
        for row, m, s in zip(ids, mask, texts):
            assert list(row[: m.sum()]) == ref(s)
    hashed = HashTokenizer(vocab_size=1000, max_length=64).encode_batch(["w1 w2, w3"], 64)[0][0]
    assert list(hashed[hashed != 1]) == hash_ids("w1 w2, w3", 1000)
