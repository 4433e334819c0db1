"""The two-stage path: models/xlmr.py token embeddings, the TextEncoder token
methods, encode_corpus(tokens_per_doc), pipeline/rerank.py and the run-rerank
CLI, against the JAX package on the same inputs (weights carried across from
the Flax params; f32 on the CPU, so 1e-5 abs where sums run in another
order; int8 token codes within one step and scales rel 1e-4, since the two
encoders' f32 outputs differ by ~1e-6 and can cross a rounding boundary).
"""

import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex as PortIndex
from codemix_dense_retrieval_torch.io.token_shards import TokenShardStore as PortTokens
from codemix_dense_retrieval_torch.io.token_shards import TokenShardWriter as PortWriter
from codemix_dense_retrieval_torch.models.encoder import TextEncoder as PortEncoder
from codemix_dense_retrieval_torch.models.encoder import build_model
from codemix_dense_retrieval_torch.models.xlmr import XLMRConfig as PortCfg
from codemix_dense_retrieval_torch.pipeline import corpus as port_corpus
from codemix_dense_retrieval_torch.pipeline import rerank as port
from codemix_dense_retrieval_torch.pipeline.query_cache import save_query_token_cache
from codemix_dense_retrieval_tpu.index.flat import DenseFlatIndex as RefIndex
from codemix_dense_retrieval_tpu.io.token_shards import TokenShardStore as RefTokens
from codemix_dense_retrieval_tpu.models import xlmr as ref_xlmr
from codemix_dense_retrieval_tpu.models.encoder import TextEncoder as RefEncoder
from codemix_dense_retrieval_tpu.parallel.mesh import make_mesh
from codemix_dense_retrieval_tpu.pipeline import corpus as ref_corpus
from codemix_dense_retrieval_tpu.pipeline import rerank as ref

TINY = dict(vocab_size=500, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            max_position_embeddings=66)


@pytest.fixture(scope="module")
def encoders():
    ref_enc = RefEncoder("BAAI/bge-m3", ref_xlmr.XLMRConfig.tiny(**TINY, use_flash=False), seed=3)
    params = jax.tree_util.tree_map(np.asarray, ref_enc.params)
    port_enc = PortEncoder("BAAI/bge-m3", PortCfg.tiny(**TINY, use_flash=False), params, device="cpu")
    return ref_enc, port_enc, params


def _ids(seed, b=3, s=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 499, size=(b, s)).astype(np.int32)
    ids[:, 0] = 0
    mask = np.ones((b, s), np.int32)
    for i, n in enumerate([s, s - 4, 5]):
        ids[i, n:] = 1
        mask[i, n:] = 0
    return ids, mask


def test_token_embeddings_and_embed_with_tokens_match_jax(encoders):
    _, _, params = encoders
    ids, mask = _ids(0)
    cfg = ref_xlmr.XLMRConfig.tiny(**TINY, use_flash=False)
    model = ref_xlmr.XLMREncoder(cfg)
    want_t = np.asarray(model.apply(params, jnp.asarray(ids), jnp.asarray(mask), method="token_embeddings"))
    want_p, want_t2 = model.apply(params, jnp.asarray(ids), jnp.asarray(mask), method="embed_with_tokens")
    pm = build_model(PortCfg.tiny(**TINY, use_flash=False), torch.device("cpu"), params)
    with torch.no_grad():
        got_t = pm.token_embeddings(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).numpy()
        got_p, got_t2 = pm.embed_with_tokens(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    np.testing.assert_allclose(got_t, want_t, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_t2.numpy(), np.asarray(want_t2), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0, atol=1e-5)
    assert (got_t[mask == 0] == 0).all()
    np.testing.assert_allclose(np.linalg.norm(got_t[mask == 1], axis=-1), 1.0, atol=1e-5)


def test_encoder_token_methods_match_jax(encoders):
    ref_enc, port_enc, _ = encoders
    texts = ["short one", "a somewhat longer query text with words", "mid length text here", "x"]
    rt, rl = ref_enc.encode_queries_tokens(texts, batch_size=2)
    pt, pl = port_enc.encode_queries_tokens(texts, batch_size=2)
    assert pt.shape == rt.shape
    np.testing.assert_array_equal(pl, rl)
    np.testing.assert_allclose(pt, rt, rtol=0, atol=1e-5)
    rd, rt2, rl2 = ref_enc.encode_documents_with_tokens(texts, batch_size=3)
    pd, pt2, pl2 = port_enc.encode_documents_with_tokens(texts, batch_size=3)
    np.testing.assert_array_equal(pl2, rl2)
    np.testing.assert_allclose(pd, rd, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pt2.numpy(), rt2, rtol=0, atol=1e-5)
    dt, dl = port_enc.encode_documents_tokens(texts, batch_size=3)
    np.testing.assert_allclose(dt.numpy(), pt2.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(dl, pl2)
    # max_tokens keeps each doc's first tokens, with its full valid count
    _, cut, cl = port_enc.encode_documents_with_tokens(texts, batch_size=3, max_tokens=4)
    np.testing.assert_array_equal(cut.numpy(), pt2.numpy()[:, :4])
    np.testing.assert_array_equal(cl, pl2)
    cut2, _ = port_enc.encode_documents_tokens(texts, batch_size=3, max_tokens=4)
    np.testing.assert_array_equal(cut2.numpy(), dt.numpy()[:, :4])
    # pack=True (ported): the packed encode's dense rows and token blocks
    # within the JAX suite's packed tolerance of the unpacked ones
    kd, kt, kl = port_enc.encode_documents_with_tokens(texts, batch_size=3, pack=True)
    np.testing.assert_array_equal(kl, pl2)
    np.testing.assert_allclose(kd, pd, rtol=5e-4, atol=5e-5)
    cut_t = min(kt.shape[1], pt2.shape[1])
    np.testing.assert_allclose(kt.numpy()[:, :cut_t], pt2.numpy()[:, :cut_t], rtol=5e-4, atol=5e-5)


def _src(lang, n=24):
    rng = random.Random(lang)
    return [(f"c{i}", f"{lang} " + " ".join(f"w{rng.randint(0, 400)}" for _ in range(rng.randint(3, 30))))
            for i in range(n)]


def _assert_token_stores_close(a, b):
    assert a.docids == b.docids and a.tokens_per_doc == b.tokens_per_doc
    np.testing.assert_array_equal(a.lengths, b.lengths)
    rows = np.arange(a.count)
    aq, asc, _ = a.gather_quantized(rows)
    bq, bsc, _ = b.gather_quantized(rows)
    assert np.abs(aq.astype(np.int32) - np.asarray(bq).astype(np.int32)).max() <= 1
    np.testing.assert_allclose(asc, bsc, rtol=1e-4, atol=0)


def test_encode_corpus_with_tokens_matches_jax(encoders, tmp_path):
    ref_enc, port_enc, _ = encoders
    sources = {"xx": _src("xx"), "yy": _src("yy")}
    for mod, enc, out in ((ref_corpus, ref_enc, "ref"), (port_corpus, port_enc, "port")):
        mod.encode_corpus(enc, dict(sources), tmp_path / out, batch_size=8, enc_batch=4,
                          storage_dtype="int8", tokens_per_doc=8)
    for lang in sources:
        got = PortTokens.open(tmp_path / "port" / lang / "tokens")
        want = RefTokens.open(tmp_path / "ref" / lang / "tokens")
        _assert_token_stores_close(got, want)
        # the JAX package reads the port's store
        _assert_token_stores_close(RefTokens.open(tmp_path / "port" / lang / "tokens"), want)
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert meta["tokens_per_doc"] == 8 and meta["token_dtype"] == "int8"


def test_encode_corpus_token_backfill_and_crash_resume(encoders, tmp_path, monkeypatch):
    _, enc, _ = encoders
    src = {"xx": _src("xx")}
    port_corpus.encode_corpus(enc, dict(src), tmp_path / "clean", batch_size=8, enc_batch=4,
                              tokens_per_doc=8)
    clean = PortTokens.open(tmp_path / "clean" / "xx" / "tokens")
    # a dense-only store gets its token store backfilled on the next run
    port_corpus.encode_corpus(enc, dict(src), tmp_path / "fill", batch_size=8, enc_batch=4)
    assert not PortTokens.exists(tmp_path / "fill" / "xx" / "tokens")
    port_corpus.encode_corpus(enc, dict(src), tmp_path / "fill", batch_size=8, enc_batch=4,
                              tokens_per_doc=8)
    _assert_token_stores_close(PortTokens.open(tmp_path / "fill" / "xx" / "tokens"), clean)
    # a crash between the dense and the token append of the second batch
    calls = {"n": 0}
    real_append = PortWriter.append

    def crash_second(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")
        return real_append(self, *a, **kw)

    monkeypatch.setattr(PortWriter, "append", crash_second)
    with pytest.raises(RuntimeError, match="simulated"):
        port_corpus.encode_corpus(enc, dict(src), tmp_path / "crash", batch_size=8, enc_batch=4,
                                  tokens_per_doc=8)
    monkeypatch.undo()
    port_corpus.encode_corpus(enc, dict(src), tmp_path / "crash", batch_size=8, enc_batch=4,
                              tokens_per_doc=8)
    _assert_token_stores_close(PortTokens.open(tmp_path / "crash" / "xx" / "tokens"), clean)


def _corpus(seed, n=64, td=8, d=32, tq=4, nq=6):
    rng = np.random.default_rng(seed)

    def normed(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    doc_toks = normed(n, td, d)
    doc_lens = rng.integers(1, td + 1, size=n)
    doc_lens[:4] = td
    doc_toks *= (np.arange(td)[None] < doc_lens[:, None])[..., None]
    dense = doc_toks.sum(axis=1)
    dense /= np.linalg.norm(dense, axis=-1, keepdims=True)
    q_toks = normed(nq, tq, d)
    q_lens = np.array([tq, tq, 2, 3, 1, tq])[:nq]
    q_dense = q_toks.sum(axis=1)
    q_dense /= np.linalg.norm(q_dense, axis=-1, keepdims=True)
    return dense, doc_toks, doc_lens, q_dense, q_toks, q_lens


def _pair(tmp_path, dtype, seed=0, rows_per_file=24):
    dense, doc_toks, doc_lens, q_dense, q_toks, q_lens = _corpus(seed)
    ids = [f"d{i}" for i in range(len(dense))]
    w = PortWriter(tmp_path / "tok", token_dim=doc_toks.shape[2], tokens_per_doc=8, dtype=dtype,
                   rows_per_file=rows_per_file)
    w.append(doc_toks, doc_lens, ids)
    w.finalize()
    ref_ix = RefIndex.build(dense, ids).to_device(make_mesh(shard=1, tp=1), pad_multiple=64)
    port_ix = PortIndex.build(dense, ids).to_device("cpu", pad_multiple=64)
    return ref_ix, port_ix, (q_dense, q_toks, q_lens)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_two_stage_resident_memmap_and_jax_give_the_same_ids(tmp_path, dtype):
    ref_ix, port_ix, q = _pair(tmp_path, dtype)
    rs, ri = ref.TwoStageSearcher(ref_ix, RefTokens.open(tmp_path / "tok")).search(
        *q, 5, k_dense=16, return_docids=False)
    store = PortTokens.open(tmp_path / "tok")
    assert store._parts is not None  # 64 rows in files of 24: gathered per part
    for kw in (dict(device_resident=True), dict(device_resident=False, dedupe=True),
               dict(device_resident=False, dedupe=False)):
        s = port.TwoStageSearcher(port_ix, store, **kw)
        assert s.device_resident == kw["device_resident"]
        for qb in (0, 4):
            gs, gi = s.search(*q, 5, k_dense=16, query_block=qb, return_docids=False)
            np.testing.assert_array_equal(gi, np.asarray(ri), err_msg=str(kw))
            np.testing.assert_allclose(gs, np.asarray(rs), rtol=0, atol=1e-5)
    assert s.last_depths == {"k_requested": 5, "k_effective": 5, "k_dense_requested": 16,
                             "k_dense_effective": 16}
    _, docids = s.search(*q, 5, k_dense=16)
    assert docids[0][0] == f"d{gi[0][0]}"
    # the dense stage may run the sketch tier; guaranteed mode keeps the ids
    port_ix.enable_sketch(sketch_dim=8, cache=False)
    sg = port.TwoStageSearcher(port_ix, store, approx="guaranteed")
    np.testing.assert_array_equal(sg.search(*q, 5, k_dense=16, return_docids=False)[1], np.asarray(ri))


def test_two_stage_resident_auto_choice_and_budget(tmp_path):
    _, port_ix, _ = _pair(tmp_path, "int8")
    store = PortTokens.open(tmp_path / "tok")
    assert port.TwoStageSearcher(port_ix, store).device_resident
    assert not port.TwoStageSearcher(port_ix, store, device_budget_bytes=1000).device_resident
    with pytest.raises(ValueError, match="budget"):
        port.TwoStageSearcher(port_ix, store, device_resident=True, device_budget_bytes=1000)


def test_two_stage_refuses_misaligned_stores_and_unported_parts(tmp_path):
    dense, doc_toks, doc_lens, *_ = _corpus(1)
    ids = [f"d{i}" for i in range(len(dense))]
    w = PortWriter(tmp_path / "tok", token_dim=32, tokens_per_doc=8)
    w.append(doc_toks, doc_lens, ids[::-1])
    w.finalize()
    port_ix = PortIndex.build(dense, ids).to_device("cpu", pad_multiple=64)
    with pytest.raises(ValueError, match="desynced"):
        port.TwoStageSearcher(port_ix, PortTokens.open(tmp_path / "tok"))
    short = PortIndex.build(dense[:10], ids[:10]).to_device("cpu")
    with pytest.raises(ValueError, match="not the same corpus"):
        port.TwoStageSearcher(short, PortTokens.open(tmp_path / "tok"))
    _, port_ix2, _ = _pair(tmp_path / "b", "int8")
    s = port.TwoStageSearcher(port_ix2, PortTokens.open(tmp_path / "b" / "tok"))
    # online mutation, ported since, refuses what the JAX package refuses: an
    # add that would regrow the dense index (64 rows in a capacity of 64) and
    # the read-only memmap store
    with pytest.raises(ValueError, match="would regrow the dense index"):
        s.add(np.zeros((1, 32), np.float32), ["new"], np.zeros((1, 8, 32), np.float32), [8])
    mm = port.TwoStageSearcher(port_ix2, PortTokens.open(tmp_path / "b" / "tok"), device_resident=False)
    with pytest.raises(ValueError, match="device-resident"):
        mm.remove(["d1"])
    assert s.count == 64 and port_ix2.mutation_epoch == 0
    # the bilingual hub checks each language's pair as it builds its searchers
    with pytest.raises(ValueError, match="desynced"):
        port.run_two_stage_bilingual([port_ix2, port_ix], [PortTokens.open(tmp_path / "b" / "tok"),
                                                           PortTokens.open(tmp_path / "tok")], None, {}, tmp_path)


def test_run_two_stage_search_trec_equals_jax(tmp_path):
    ref_ix, port_ix, (q_dense, q_toks, q_lens) = _pair(tmp_path, "int8")
    qids = [f"q{i}" for i in range(len(q_dense))]
    sets = {"cm0-20": [(q, "unused text") for q in qids]}
    save_query_token_cache(tmp_path / "cache" / "cm0-20.npz", qids, q_dense, q_toks, q_lens)
    ref_runs = ref.run_two_stage_search(ref_ix, RefTokens.open(tmp_path / "tok"), None, sets,
                                        tmp_path / "ref", k=5, k_dense=16, cache_root=tmp_path / "cache")
    port_runs = port.run_two_stage_search(port_ix, PortTokens.open(tmp_path / "tok"), None, sets,
                                          tmp_path / "port", k=5, k_dense=16, cache_root=tmp_path / "cache")
    assert port_runs["cm0-20"].read_text() == ref_runs["cm0-20"].read_text()
    assert json.loads((tmp_path / "port" / "cm0-20_meta.json").read_text()) == json.loads(
        (tmp_path / "ref" / "cm0-20_meta.json").read_text())


def test_cli_encode_tokens_then_run_rerank(tmp_path, capsys):
    from codemix_dense_retrieval_torch.cli import main

    corpus = tmp_path / "c.tsv"
    corpus.write_text("".join(f"d{i}\tpassage {i} about topic {i % 5} words w{i}\n" for i in range(40)))
    queries = tmp_path / "cm0-20.tsv"
    queries.write_text("".join(f"q{i}\ttopic {i} query\n" for i in range(6)))
    main(["encode-corpus", "--device", "cpu", "--smoke_dim", "32", "--corpus_tsv", f"xx={corpus}",
          "--out", str(tmp_path / "ix"), "--storage_dtype", "int8", "--tokens_per_doc", "8",
          "--batch", "16", "--enc_batch", "8"])
    assert PortTokens.open(tmp_path / "ix" / "xx" / "tokens").count == 40
    capsys.readouterr()
    main(["run-rerank", "--device", "cpu", "--smoke_dim", "32", "--index", str(tmp_path / "ix" / "xx"),
          "--queries", str(queries), "--outdir", str(tmp_path / "runs"), "--k", "5", "--k_dense", "12",
          "--query_cache", str(tmp_path / "qc")])
    runs = json.loads(capsys.readouterr().out)
    lines = (tmp_path / "runs" / "cm0-20.trec").read_text().splitlines()
    assert list(runs) == ["cm0-20"] and len(lines) == 6 * 5
    assert (tmp_path / "qc" / "cm0-20.npz").exists()
    meta = json.loads((tmp_path / "runs" / "cm0-20_meta.json").read_text())
    assert meta["k_dense_effective"] == 12 and meta["n_queries"] == 6
    # two indexes: the bilingual hub (raw run, collapsed run, meta)
    main(["run-rerank", "--device", "cpu", "--smoke_dim", "32", "--index", str(tmp_path / "ix" / "xx"),
          str(tmp_path / "ix" / "xx"), "--queries", str(queries), "--outdir", str(tmp_path / "r2"),
          "--k", "5", "--k_dense", "12", "--query_cache", str(tmp_path / "qc")])
    assert json.loads(capsys.readouterr().out) == {"cm0-20": str(tmp_path / "r2" / "cm0-20_base.trec")}
    assert len((tmp_path / "r2" / "cm0-20_raw.trec").read_text().splitlines()) == 6 * 5
    with pytest.raises(SystemExit, match="not a token store"):
        main(["run-rerank", "--device", "cpu", "--index", str(tmp_path / "ix"), "--queries", str(queries),
              "--outdir", str(tmp_path / "r3")])
