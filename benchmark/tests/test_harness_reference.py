"""The plain reference against the port's outputs on the same inputs, at
small sizes on the CPU (both in float32 here)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import tiny_cell


def _encoder(cell, tmp_path, dtype=torch.float32):
    from harness import text, weights

    c, m = cell.config, cell.config["model"]
    import harness.core as core

    fam = core.load_module(core.BENCH / "families" / f"{c['family']}.py", f"families.{c['family']}")
    w = weights.make(fam.shapes(m), 123, "cpu", dtype, c["init_std"])
    tok = text.port_tokenizer({**c["tokenizer"], "kind": "hash"}, m["vocab_size"], m["max_position_embeddings"] - 2,
                              tmp_path)
    enc = fam.port_encoder(c, w, tok, torch.device("cpu"), dtype)
    return fam, enc, {k: v.float() for k, v in w.items()}, text.reference_tokenizer({"kind": "hash"}, m["vocab_size"])


@pytest.mark.parametrize("name", ["bge-m3.encode-corpus", "qwen3-0.6b.encode-corpus"])
def test_reference_forward_matches_the_port(name, tmp_path):
    cell = tiny_cell(name)
    fam, enc, w, ref_tok = _encoder(cell, tmp_path)
    texts = ["w1 w2 w3", " ".join(f"w{j:x}" for j in range(40)), "w5, w6 w7 w8 w9"]
    got = torch.from_numpy(enc.encode_documents(texts, batch_size=2))
    want = torch.stack([fam.reference.embed(w, cell.config["model"], ref_tok(s)) for s in texts])
    assert (got - want).abs().max() < 2e-5


def test_reference_queries_take_the_family_prefix(tmp_path):
    cell = tiny_cell("qwen3-0.6b.encode-corpus")
    fam, enc, w, ref_tok = _encoder(cell, tmp_path)
    got = torch.from_numpy(enc.encode_queries(["w1 w2"]))
    want = fam.reference.embed(w, cell.config["model"], ref_tok(cell.config["query_prefix"] + "w1 w2"))
    assert (got[0] - want).abs().max() < 2e-5


def test_exact_topk_matches_the_port_search_with_ties_to_the_lower_id():
    from harness import data
    from reference import search as ref

    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex

    rows = data.IndexRows(20_000, 32, 9, "cpu")
    host = rows.host()
    host[7000] = host[123]            # a tie: the lower id comes first
    index = DenseFlatIndex.build(host, [str(i) for i in range(20_000)]).to_device("cpu")
    a, b = data.query_pairs(40, 32, 0.5, 9, "cpu")
    q = ref.safe_mix(a, b, 0.25)
    q[0] = host[123].float()
    vals, ids = index.search(q.numpy(), 20, return_docids=False)
    rv, ri, picked = ref.exact_topk(q.to(torch.bfloat16).float(), lambda c0, c1: host[c0:c1], 20_000, 20,
                                    block=4096, score_ids=torch.from_numpy(ids))
    assert (ri.numpy() == ids).all()
    assert np.abs(rv.numpy() - vals).max() < 1e-6
    assert torch.equal(picked, rv)
    assert ri[0, 0] == 123 and ri[0, 1] == 7000


def test_safe_mix_matches_the_port_mix():
    from harness import data
    from reference import search as ref

    from codemix_dense_retrieval_torch.ops.mix import mix_and_renorm

    a, b = data.query_pairs(16, 8, 0.5, 3, "cpu")
    for alpha in (0.0, 0.1, 0.5, 0.9, 1.0):
        assert torch.allclose(ref.safe_mix(a, b, alpha), mix_and_renorm(a, b, alpha), atol=1e-7)

