"""The pipelines over 8 shards against the JAX package on its 8 forced CPU
devices (Pallas in interpret mode), the port's 8 shards on the CPU, the
same numpy inputs: the fused alpha sweep and its metrics, the bilingual
hub (fused and unfused run files), the two-stage rerank with its online
mutation and save, the search service with ``/reload``, and the CLI
(``run-mix --shards 8``, ``encode-corpus --dp 2``); and the data-parallel
TextEncoder.

Tolerances, as in the one-shard tests of each pipeline: ids equal; values
and metrics within 1e-5 (torch's matmul and XLA's dot sum a row's products
in another order); run files byte-equal where both packages score the same
f32 products (the hub's rows with two nonzero coordinates, or bf16 rows at
the CLI's 4 decimals, as tests/test_torch_runs.py). The two packages'
encoders give rows within one bf16 ulp of each other (tests/test_torch_corpus.py),
so ``encode-corpus --dp 2`` is held to that bound against the JAX CLI and
to bit equality against the port's own one-device encode.
"""

import json
import random
import zlib

import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex as PortIndex
from codemix_dense_retrieval_torch.io.shards import ShardStore as PortStore
from codemix_dense_retrieval_torch.io.token_shards import TokenShardStore as PortTokens
from codemix_dense_retrieval_torch.io.token_shards import TokenShardWriter as PortWriter
from codemix_dense_retrieval_torch.parallel.mesh import make_mesh as port_mesh
from codemix_dense_retrieval_torch.pipeline import bilingual as port_bi
from codemix_dense_retrieval_torch.pipeline import fused as port_fused
from codemix_dense_retrieval_torch.pipeline import rerank as port_rerank
from codemix_dense_retrieval_torch.pipeline.query_cache import save_query_cache
from codemix_dense_retrieval_torch.serving import SearchService as PortService
from codemix_dense_retrieval_tpu.index.flat import DenseFlatIndex as RefIndex
from codemix_dense_retrieval_tpu.io.token_shards import TokenShardStore as RefTokens
from codemix_dense_retrieval_tpu.parallel.mesh import make_mesh as ref_mesh
from codemix_dense_retrieval_tpu.pipeline import bilingual as ref_bi
from codemix_dense_retrieval_tpu.pipeline import fused as ref_fused
from codemix_dense_retrieval_tpu.pipeline import rerank as ref_rerank
from codemix_dense_retrieval_tpu.serving import SearchService as RefService

S = 8
TOL = 1e-5
WAIT = 30
ALPHAS = [0.0, 0.3, 0.5, 1.0]


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _cpu8():
    return port_mesh(shard=S, devices=["cpu"] * S)


def _pair(devs, docs, ids, dtype="bfloat16", pad=128, **kw):
    ref = RefIndex.build(docs, ids, dtype=dtype, **kw).to_device(ref_mesh(shard=S, tp=1, devices=devs),
                                                                 pad_multiple=pad)
    port = PortIndex.build(docs, ids, dtype=dtype, **kw).to_device(_cpu8(), pad_multiple=pad)
    return ref, port


# ---------------------------------------------------------------- fused sweep


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_fused_sweep_over_8_shards_matches_jax(eight_cpu_devices, dtype):
    rng = np.random.default_rng(1)
    n, d, b, k = 2000, 32, 12, 20
    docs = _unit(rng.standard_normal((n, d)))
    ids = [f"d{i}" for i in range(n)]
    primary, secondary = _unit(rng.standard_normal((b, d))), _unit(rng.standard_normal((b, d)))
    rel = rng.integers(0, n, (b, 2))
    ref_ix, port_ix = _pair(eight_cpu_devices, docs, ids, dtype)
    rv, ri, rm, _ = ref_fused.fused_alpha_sweep(
        primary, secondary, ALPHAS, ref_ix._docs_dev, ref_ix._counts_dev, k, mesh=ref_ix.mesh,
        search_kwargs=ref_ix.search_kwargs, rel_ids=rel)
    pv, pi, pm, pc = port_fused.sweep_index(port_ix, primary, secondary, ALPHAS, k, rel_ids=rel, query_block=8)
    assert pc is None
    np.testing.assert_array_equal(pi, np.asarray(ri))
    np.testing.assert_allclose(pv, np.asarray(rv), rtol=0, atol=TOL)
    assert sorted(pm) == sorted(rm)
    for name in rm:
        np.testing.assert_allclose(pm[name], np.asarray(rm[name]), rtol=0, atol=TOL, err_msg=name)
    # the fused ids are the unfused search's
    for ai, alpha in enumerate(ALPHAS):
        mixed = _unit((1 - alpha) * primary + alpha * secondary)
        np.testing.assert_array_equal(pi[ai], port_ix.search(mixed, k, return_docids=False)[1])


def test_fused_guaranteed_sweep_over_8_shards_equals_exact(eight_cpu_devices):
    rng = np.random.default_rng(2)
    n, d, b, k = 2400, 32, 10, 10
    docs = _unit(rng.standard_normal((n, d)) * np.exp(-0.08 * np.arange(d)))
    primary, secondary = _unit(rng.standard_normal((b, d))), _unit(rng.standard_normal((b, d)))
    ref_ix, port_ix = _pair(eight_cpu_devices, docs, [f"d{i}" for i in range(n)])
    port_ix.enable_sketch(sketch_dim=8, cache=False)
    _, exact_ids, _, _ = port_fused.sweep_index(port_ix, primary, secondary, ALPHAS, k, query_block=8)
    _, ids, _, cert = port_fused.sweep_index(port_ix, primary, secondary, ALPHAS, k, approx="guaranteed",
                                             query_block=8)
    np.testing.assert_array_equal(ids, exact_ids)
    assert cert.shape == (len(ALPHAS), b)
    rv, ri, _, _ = ref_fused.fused_alpha_sweep(
        primary, secondary, ALPHAS, ref_ix._docs_dev, ref_ix._counts_dev, k, mesh=ref_ix.mesh,
        search_kwargs=ref_ix.search_kwargs)
    np.testing.assert_array_equal(ids, np.asarray(ri))


# ---------------------------------------------------------------- bilingual hub


def _sparse_hub(seed=0, n1=900, d=32, b=10):
    """Two parallel languages of rows with two nonzero coordinates (the
    same two in both), queries whose secondary side lies near a planted
    row (tests/test_torch_bilingual.py's data)."""
    rng = np.random.default_rng(seed)
    keep = np.zeros((n1, d), bool)
    keep[np.arange(n1)[:, None], np.argsort(rng.random((n1, d)), axis=1)[:, :2]] = True
    docs_a = rng.standard_normal((n1, d)) * keep
    docs_b = (docs_a + 0.3 * rng.standard_normal((n1, d))) * keep
    docs_a, docs_b = _unit(docs_a), _unit(docs_b)
    rel = rng.choice(n1, size=b, replace=False)
    primary = _unit(rng.standard_normal((b, d)))
    secondary = _unit(docs_b[rel] + 0.05 * rng.standard_normal((b, d)))
    return docs_a, docs_b, [f"doc{i}" for i in range(n1)], rel, primary, secondary, [f"q{i}" for i in range(b)]


def test_hub_runs_over_8_shards_are_byte_identical(eight_cpu_devices, tmp_path):
    docs_a, docs_b, ids, rel, primary, secondary, qids = _sparse_hub()
    ref_hub = RefIndex.merged([RefIndex.build(docs_a, ids, lang="en"), RefIndex.build(docs_b, ids, lang="zh")])
    ref_hub.to_device(ref_mesh(shard=S, tp=1, devices=eight_cpu_devices), pad_multiple=128)
    port_hub = PortIndex.merged([PortIndex.build(docs_a, ids, lang="en"), PortIndex.build(docs_b, ids, lang="zh")])
    port_hub.to_device(_cpu8(), pad_multiple=128)
    assert len(port_hub._docs_dev) == S and port_hub._rows_per_shard == ref_hub._rows_per_shard
    qrels = {q: {ids[r]: 1} for q, r in zip(qids, rel)}
    _, want_m = ref_bi.run_bilingual_vector_mix_fused(ref_hub, qids, primary, secondary, ALPHAS,
                                                      tmp_path / "ref_f", k=25, qrels=qrels)
    _, got_m = port_bi.run_bilingual_vector_mix_fused(port_hub, qids, primary, secondary, ALPHAS,
                                                      tmp_path / "port_f", k=25, qrels=qrels, query_block=4)
    ref_bi.run_bilingual_vector_mix(ref_hub, qids, primary, secondary, ALPHAS, tmp_path / "ref_u", k=30,
                                    query_block=4)
    port_bi.run_bilingual_vector_mix(port_hub, qids, primary, secondary, ALPHAS, tmp_path / "port_u", k=30,
                                     query_block=4)
    for label in want_m:
        for name, v in want_m[label].items():
            assert got_m[label][name] == pytest.approx(v, abs=1e-4), (label, name)
    for a in ("0", "0.3", "0.5", "1"):
        name = f"cm-alpha-{a}_base.trec"
        assert (tmp_path / "port_f" / name).read_bytes() == (tmp_path / "ref_f" / name).read_bytes(), name
        for name in (f"cm-alpha-{a}_raw.trec", f"cm-alpha-{a}_base.trec"):
            assert (tmp_path / "port_u" / name).read_bytes() == (tmp_path / "ref_u" / name).read_bytes(), name
        for sub in ("f", "u"):
            got = json.loads((tmp_path / f"port_{sub}" / f"cm-alpha-{a}_meta.json").read_text())
            want = json.loads((tmp_path / f"ref_{sub}" / f"cm-alpha-{a}_meta.json").read_text())
            got.pop("timestamp"), want.pop("timestamp")
            assert got == want


# ---------------------------------------------------------------- two-stage


def _tok_corpus(rng, n, t, d=32):
    toks = _unit(rng.standard_normal((n, t, d)))
    return toks, _unit(toks.sum(axis=1))


def test_two_stage_over_8_shards_matches_jax(eight_cpu_devices, tmp_path):
    """The dense stage over 8 shards, token blocks at the global padded
    positions (``cap = S * rows_per_shard``): search, add, remove (swaps
    inside a shard) and save equal the JAX package's."""
    rng = np.random.default_rng(7)
    n, td = 200, 4
    toks, dense = _tok_corpus(rng, n, td)
    lens = rng.integers(1, td + 1, n).astype(np.int32)
    ids = [f"d{i}" for i in range(n)]
    w = PortWriter(tmp_path / "tok", token_dim=32, tokens_per_doc=td, dtype="int8")
    w.append(toks, lens, ids)
    w.finalize()
    ref_ix, port_ix = _pair(eight_cpu_devices, dense, ids, "float32", pad=64)
    ref = ref_rerank.TwoStageSearcher(ref_ix, RefTokens.open(tmp_path / "tok"), device_resident=True)
    port = port_rerank.TwoStageSearcher(port_ix, PortTokens.open(tmp_path / "tok"), device_resident=True)
    qt, qd = _tok_corpus(rng, 5, td)
    ql = np.full(5, td)

    def same_search():
        rs, rd = ref.search(qd, qt, ql, 5, k_dense=24)
        ps, pd = port.search(qd, qt, ql, 5, k_dense=24)
        np.testing.assert_array_equal(pd, rd)
        np.testing.assert_allclose(ps, rs, rtol=0, atol=TOL)

    same_search()
    add_toks, add_dense = _tok_corpus(rng, 9, td)
    add_lens = rng.integers(1, td + 1, 9).astype(np.int32)
    names = [f"n{i}" for i in range(9)]
    want = ref.add(add_dense, names, add_toks, add_lens)
    got = port.add(add_dense, names, torch.from_numpy(add_toks), add_lens)
    np.testing.assert_array_equal(got, want)
    cap = S * port_ix._rows_per_shard
    assert port._tok_dev.shape[0] == cap == np.asarray(ref._tok_dev).shape[0]
    np.testing.assert_array_equal(port._tok_dev.numpy(), np.asarray(ref._tok_dev))
    np.testing.assert_array_equal(port._lengths_dev.numpy(), np.asarray(ref._lengths_dev))
    batch = ["d3", "n0", "d150", "ghost", str(port_ix.docids[port_ix._rows_per_shard])]
    assert ref.remove(batch) == port.remove(batch) == 4
    assert port_ix.last_swaps == ref_ix.last_swaps
    np.testing.assert_array_equal(port._tok_dev.numpy(), np.asarray(ref._tok_dev))
    np.testing.assert_array_equal(port._scales_dev.numpy(), np.asarray(ref._scales_dev))
    same_search()
    ref.save(tmp_path / "ref_snap")
    port.save(tmp_path / "port_snap")
    rt, pt = RefTokens.open(tmp_path / "ref_snap" / "tokens"), PortTokens.open(tmp_path / "port_snap" / "tokens")
    assert pt.docids == rt.docids
    np.testing.assert_array_equal(pt.lengths, rt.lengths)
    rows = np.arange(pt.count)
    for a, b in zip(pt.gather_quantized(rows), rt.gather_quantized(rows)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- serving


class _Encoder:
    """Deterministic text -> unit vector (seeded by a CRC of the text)."""

    def encode_queries(self, texts, batch_size=64):
        out = np.zeros((len(texts), 32), np.float32)
        for i, t in enumerate(texts):
            v = np.random.default_rng(zlib.crc32(t.encode())).standard_normal(32)
            out[i] = v / np.linalg.norm(v)
        return out


def test_service_replies_and_reload_over_8_shards_match_jax(eight_cpu_devices, tmp_path):
    """One request sequence (searches, an add, a remove, /save, /reload)
    through both packages' services over 8-shard indexes: the same replies;
    the reloaded index keeps the live one's mesh."""
    rng = np.random.default_rng(21)
    rows, ids = _unit(rng.standard_normal((500, 32))), [f"d{i}" for i in range(500)]
    ref_ix, port_ix = _pair(eight_cpu_devices, rows, ids, pad=128)
    other = _unit(rng.standard_normal((300, 32)))
    PortIndex.build(other, [f"o{i}" for i in range(300)]).save(tmp_path / "snap")
    steps = [
        ("search", (["alpha"], 5)),
        ("add", [{"docid": "new-1", "text": "alpha"}, {"docid": "new-2", "text": "delta"}]),
        ("search", (["alpha", "delta", "omega"], 3)),
        ("remove", ["d3", "new-1", "ghost"]),
        ("search", (["alpha", "beta", "gamma"], 50)),
        ("reload", "snap"),
        ("search", (["alpha", "beta"], 7)),
    ]
    replies = []
    for svc_cls, ix in ((RefService, ref_ix), (PortService, port_ix)):
        svc = svc_cls(_Encoder(), ix, snapshot_root=str(tmp_path))
        out = []
        try:
            for op, arg in steps:
                if op == "search":
                    out.append(svc.submit(*arg).result(WAIT))
                elif op == "add":
                    out.append(svc.submit_add(arg).result(WAIT))
                elif op == "remove":
                    out.append(svc.submit_remove(arg).result(WAIT))
                else:
                    out.append(svc.submit_reload(arg).result(WAIT))
            if svc_cls is PortService:
                assert svc.index.mesh.shape == {"shard": S, "tp": 1} and len(svc.index._docs_dev) == S
        finally:
            svc.close()
        replies.append(json.loads(json.dumps(out)))
    for (op, _), r, p in zip(steps, *replies):
        if op != "search":
            assert p == r
            continue
        for pr, rr in zip(p, r):
            assert [h["docid"] for h in pr] == [h["docid"] for h in rr]
            np.testing.assert_allclose([h["score"] for h in pr], [h["score"] for h in rr], rtol=0, atol=TOL)


# ---------------------------------------------------------------- CLI


def test_cli_run_mix_with_8_shards_equals_the_jax_cli(tmp_path):
    """``run-mix --device cpu --shards 8`` and the JAX CLI's ``--shards 8``
    (its 8 CPU devices) over one store with one query cache write the same
    run files; so does the port's one-shard run."""
    from codemix_dense_retrieval_torch.cli import main as port_main
    from codemix_dense_retrieval_tpu.cli import main as ref_main

    rng = np.random.default_rng(3)
    n, d = 2000, 32
    PortIndex.build(rng.standard_normal((n, d)).astype(np.float32), [f"d{i}" for i in range(n)]).save(tmp_path / "ix")
    qids = [f"q{i}" for i in range(9)]
    for lang in ("en", "zh"):
        (tmp_path / f"{lang}.tsv").write_text("".join(f"{q}\t{lang} query {q}\n" for q in qids))
        save_query_cache(tmp_path / "cache" / lang / "queries.npz", qids, _unit(rng.standard_normal((9, d))))
    common = ["run-mix", "--index", str(tmp_path / "ix"), "--smoke_dim", str(d), "--k", "25",
              "--query_tsv", f"en={tmp_path / 'en.tsv'}", f"zh={tmp_path / 'zh.tsv'}",
              "--cm_alphas", "0", "0.5", "1", "--query_cache", str(tmp_path / "cache"), "--qblock", "4"]
    port_main(common + ["--device", "cpu", "--shards", "8", "--outdir", str(tmp_path / "p8")])
    port_main(common + ["--device", "cpu", "--shards", "1", "--outdir", str(tmp_path / "p1")])
    ref_main(common + ["--shards", "8", "--outdir", str(tmp_path / "r8")])
    for name in ("cm-alpha-0.trec", "cm-alpha-0.5.trec", "cm-alpha-1.trec"):
        want = (tmp_path / "r8" / name).read_bytes()
        assert len(want.splitlines()) == 9 * 25
        assert (tmp_path / "p8" / name).read_bytes() == want, name
        assert (tmp_path / "p1" / name).read_bytes() == want, name


def _corpus(path, n=70):
    rng = random.Random(0)
    path.write_text("".join(f"c{i}\t" + " ".join(f"w{rng.randint(0, 400)}" for _ in range(rng.randint(4, 40)))
                            + "\n" for i in range(n)))
    return path


def test_cli_encode_corpus_dp_2(tmp_path):
    """``encode-corpus --device cpu --dp 2`` writes the port's one-device
    store bit for bit and the JAX CLI's ``--dp 2`` store within one bf16
    ulp (the two encoders' bound); run-mix over the port's two stores
    writes the same run files."""
    from codemix_dense_retrieval_torch.cli import main as port_main
    from codemix_dense_retrieval_tpu.cli import main as ref_main
    from codemix_dense_retrieval_tpu.io.shards import ShardStore as RefStore
    from tests.test_torch_tools import _hf_xlmr_dir

    hf = _hf_xlmr_dir(tmp_path / "hf")
    corpus = _corpus(tmp_path / "c.tsv")
    common = ["encode-corpus", "--checkpoint", str(hf), "--corpus_tsv", f"xx={corpus}", "--batch", "16",
              "--enc_batch", "8"]
    port_main(common + ["--device", "cpu", "--dp", "2", "--out", str(tmp_path / "p2")])
    port_main(common + ["--device", "cpu", "--out", str(tmp_path / "p1")])
    ref_main(common + ["--dp", "2", "--out", str(tmp_path / "r2")])
    p2, p1 = PortStore.open(tmp_path / "p2" / "xx"), PortStore.open(tmp_path / "p1" / "xx")
    r2 = RefStore.open(tmp_path / "r2" / "xx")
    assert p2.docids == p1.docids == r2.docids and p2.count == 70
    np.testing.assert_array_equal(np.asarray(p2.vectors), np.asarray(p1.vectors))
    a, b = p2.rows().float().numpy(), np.asarray(r2.vectors, np.float32)
    assert (np.abs(a - b) <= np.maximum(np.abs(a), np.abs(b)) * 2.0 ** -7 + 1e-6).all()
    qids = [f"q{i}" for i in range(4)]
    rng = np.random.default_rng(5)
    for lang in ("en", "zh"):
        (tmp_path / f"{lang}.tsv").write_text("".join(f"{q}\tw1 w{i}\n" for i, q in enumerate(qids)))
        save_query_cache(tmp_path / "cache" / lang / "queries.npz", qids, _unit(rng.standard_normal((4, p1.dim))))
    for store in ("p1", "p2"):
        port_main(["run-mix", "--device", "cpu", "--checkpoint", str(hf), "--index", str(tmp_path / store / "xx"),
                   "--query_tsv", f"en={tmp_path / 'en.tsv'}", f"zh={tmp_path / 'zh.tsv'}", "--k", "10",
                   "--cm_alphas", "0.5", "--query_cache", str(tmp_path / "cache"), "--shards", "8",
                   "--outdir", str(tmp_path / f"runs_{store}")])
    assert (tmp_path / "runs_p2" / "cm-alpha-0.5.trec").read_bytes() == \
        (tmp_path / "runs_p1" / "cm-alpha-0.5.trec").read_bytes()


# ---------------------------------------------------------------- data-parallel encoder


@pytest.mark.parametrize("dp", [2, 3])
def test_text_encoder_dp_forwards_equal_one_device(dp):
    """Every forward (plain, packed, tokens, both) split over dp CPU shards
    (one replica: the device repeats) gathers the one-device rows in order."""
    from codemix_dense_retrieval_torch.models.encoder import TextEncoder
    from codemix_dense_retrieval_torch.models.xlmr import XLMRConfig

    cfg = XLMRConfig.tiny(vocab_size=500, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                          max_position_embeddings=130, use_flash=False)
    one = TextEncoder("BAAI/bge-m3", cfg, seed=3, device="cpu")
    mesh = port_mesh(shard=dp, devices=["cpu"] * dp)
    par = TextEncoder("BAAI/bge-m3", cfg, seed=3, mesh=mesh)
    assert par.device == torch.device("cpu") and par._replicas == [par.model] * dp
    rng = random.Random(1)
    texts = [" ".join(f"w{rng.randint(0, 400)}" for _ in range(rng.randint(2, 60))) for _ in range(37)]
    np.testing.assert_array_equal(par.encode_queries(texts, batch_size=8), one.encode_queries(texts, batch_size=8))
    np.testing.assert_allclose(par.encode_documents(texts, batch_size=16, pack=True),
                               one.encode_documents(texts, batch_size=16, pack=True), rtol=0, atol=1e-6)
    pt, pl = par.encode_documents_tokens(texts, batch_size=8, max_tokens=6)
    ot, ol = one.encode_documents_tokens(texts, batch_size=8, max_tokens=6)
    np.testing.assert_array_equal(pl, ol)
    np.testing.assert_array_equal(pt.numpy(), ot.numpy())
    pd, pt2, _ = par.encode_documents_with_tokens(texts, batch_size=8, max_tokens=6)
    od, ot2, _ = one.encode_documents_with_tokens(texts, batch_size=8, max_tokens=6)
    np.testing.assert_array_equal(pd, od)
    np.testing.assert_array_equal(pt2.numpy(), ot2.numpy())
