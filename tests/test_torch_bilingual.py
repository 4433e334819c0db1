"""pipeline/bilingual.py, io/shards.py::concat_stores, DenseFlatIndex.merged,
pipeline/rerank.py::run_two_stage_bilingual and the bilingual CLI commands:
the port's runners write TREC files byte-identical to the JAX package's
(``_raw`` and ``_base``) for the same vectors, with the same meta apart from
the timestamp; the CLI runs in smoke mode on the CPU.

Byte identity at 6 decimals needs the same f32 scores in both packages. On
the CPU the port scores with torch's matmul and the JAX package with XLA's
dot, which sum the d products of a dense row in different orders, so a few
percent of the scores differ in their last bit and some of those print
differently (1 to 11 of ~3,180 lines per seed, seeds 0-7). The byte
comparison on dense rows is therefore a strict expected failure that names
this cause, so a change in either backend's summation order shows. The
runners' own byte comparisons run on rows with two nonzero coordinates:
both products are exact (bf16 x bf16 fits f32) and their one rounded sum
does not depend on the order. Dense rows are held over several seeds to
exact ids and ranks, and printed scores within one unit of the 6th
decimal."""

import json
import pathlib

import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex as PortIndex
from codemix_dense_retrieval_torch.io.shards import ConcatStore, ShardStore
from codemix_dense_retrieval_torch.io.token_shards import TokenShardStore as PortTokens
from codemix_dense_retrieval_torch.io.token_shards import TokenShardWriter as PortWriter
from codemix_dense_retrieval_torch.io.tsv import write_queries_tsv
from codemix_dense_retrieval_torch.pipeline import bilingual as port
from codemix_dense_retrieval_torch.pipeline import rerank as port_rerank
from codemix_dense_retrieval_torch.pipeline.query_cache import save_query_token_cache
from codemix_dense_retrieval_tpu.index.flat import DenseFlatIndex as RefIndex
from codemix_dense_retrieval_tpu.io.shards import ShardStore as RefStore
from codemix_dense_retrieval_tpu.io.token_shards import TokenShardStore as RefTokens
from codemix_dense_retrieval_tpu.parallel.mesh import make_mesh
from codemix_dense_retrieval_tpu.pipeline import bilingual as ref
from codemix_dense_retrieval_tpu.pipeline import rerank as ref_rerank

ALPHAS = [0.0, 0.25, 0.5, 1.0]


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


class _FixedEncoder:
    """Query vectors by text, the same for both packages."""

    def __init__(self, vecs):
        self.vecs = vecs

    def encode_queries(self, texts, batch_size=64):
        return np.stack([self.vecs[t] for t in texts])


def _hub(sparse, seed=0, n1=900, d=32, b=10):
    """Two parallel languages (row i of the second is row i of the first
    perturbed), queries whose secondary side lies near a planted row."""
    rng = np.random.default_rng(seed)
    docs_a = rng.standard_normal((n1, d))
    if sparse:  # two nonzero coordinates per row, the same two in both languages
        keep = np.zeros((n1, d), bool)
        keep[np.arange(n1)[:, None], np.argsort(rng.random((n1, d)), axis=1)[:, :2]] = True
        docs_a *= keep
        docs_b = (docs_a + 0.3 * rng.standard_normal((n1, d))) * keep
    else:
        docs_b = docs_a + 0.3 * rng.standard_normal((n1, d))
    docs_a, docs_b = _unit(docs_a), _unit(docs_b)
    ids = [f"doc{i}" for i in range(n1)]
    rel = rng.choice(n1, size=b, replace=False)
    primary = _unit(rng.standard_normal((b, d)))
    secondary = _unit(docs_b[rel] + 0.05 * rng.standard_normal((b, d)))
    qids = [f"q{i}" for i in range(b)]
    return docs_a, docs_b, ids, rel, primary, secondary, qids


@pytest.fixture(scope="module")
def hub_data():
    return _hub(sparse=True)


def _hubs(docs_a, docs_b, ids_a, ids_b=None, dtype="bfloat16"):
    ids_b = ids_a if ids_b is None else ids_b
    ref_hub = RefIndex.merged([RefIndex.build(docs_a, ids_a, dtype=dtype, lang="en"),
                               RefIndex.build(docs_b, ids_b, dtype=dtype, lang="zh")])
    port_hub = PortIndex.merged([PortIndex.build(docs_a, ids_a, dtype=dtype, lang="en"),
                                 PortIndex.build(docs_b, ids_b, dtype=dtype, lang="zh")])
    return ref_hub.to_device(make_mesh(shard=1, tp=1), pad_multiple=256), port_hub.to_device("cpu", pad_multiple=256)


def _same_files(ref_dir, port_dir, names):
    for name in names:
        assert (port_dir / name).read_bytes() == (ref_dir / name).read_bytes(), name


def _same_meta(ref_dir, port_dir, name):
    want = json.loads((ref_dir / name).read_text())
    got = json.loads((port_dir / name).read_text())
    want.pop("timestamp")
    got.pop("timestamp")
    assert got == want, name


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_merged_store_matches_concat_stores(hub_data, tmp_path, dtype):
    docs_a, docs_b, ids, *_ = hub_data
    ref_hub, port_hub = _hubs(docs_a, docs_b, ids, dtype=dtype)
    store = port_hub.store
    assert isinstance(store, ConcatStore) and len(store.parts) == 2  # no host copy of the rows
    assert store.docids == ref_hub.store.docids
    assert store.derived_ids == ref_hub.store.derived_ids
    assert store.derived_ids[0] == "doc0#en" and store.derived_ids[-1] == f"doc{len(ids) - 1}#zh"
    assert store.manifest.lang == ref_hub.store.manifest.lang == "en+zh"
    assert store.count == ref_hub.store.count == 2 * len(ids)
    want = np.asarray(ref_hub.store.vectors)
    all_rows = store.rows(0, store.count).contiguous()
    np.testing.assert_array_equal(all_rows.view(torch.uint8).numpy(), want.view(np.uint8))
    with pytest.raises(AttributeError, match="rows"):
        store.vectors  # a host copy of the hub is never made
    for a, b in ((0, 5), (len(ids) - 3, len(ids) + 4), (len(ids), 2 * len(ids))):
        np.testing.assert_array_equal(store.rows(a, b).float().numpy(), want[a:b].astype(np.float32))
    if dtype == "int8":
        np.testing.assert_array_equal(store.scales, ref_hub.store.scales)
    # the device rows are the JAX package's, and the hub saves as one store
    np.testing.assert_array_equal(port_hub._docs_dev[0][: store.count].float().numpy(),
                                  np.asarray(ref_hub._docs_dev[: store.count], np.float32))
    port_hub.save(tmp_path / "hub")
    back = RefStore.open(tmp_path / "hub")
    assert back.derived_ids == store.derived_ids and back.manifest.lang == "en+zh"
    np.testing.assert_array_equal(np.asarray(back.vectors).view(np.uint8), want.view(np.uint8))
    assert ShardStore.open(tmp_path / "hub").docids == store.docids


def test_word_mix_runs_are_byte_identical(hub_data, tmp_path):
    docs_a, docs_b, ids, rel, primary, secondary, qids = hub_data
    ref_hub, port_hub = _hubs(docs_a, docs_b, ids)
    enc = _FixedEncoder({f"{s}{i}": v for s, vecs in (("a", primary), ("b", secondary))
                         for i, v in enumerate(vecs)})
    sets = {"cm0": [(q, f"a{i}") for i, q in enumerate(qids)],
            "cm100": [(q, f"b{i}") for i, q in enumerate(qids)]}
    want = ref.run_bilingual_word_mix(ref_hub, enc, sets, tmp_path / "ref", k=40, query_block=4)
    got = port.run_bilingual_word_mix(port_hub, enc, sets, tmp_path / "port", k=40, query_block=4)
    assert {k: v.name for k, v in got.items()} == {k: v.name for k, v in want.items()}
    for s in sets:
        _same_files(tmp_path / "ref", tmp_path / "port", [f"{s}_raw.trec", f"{s}_base.trec"])
        _same_meta(tmp_path / "ref", tmp_path / "port", f"{s}_meta.json")
    assert "#zh" in (tmp_path / "port" / "cm100_raw.trec").read_text()


def test_vector_mix_runs_are_byte_identical(hub_data, tmp_path):
    docs_a, docs_b, ids, rel, primary, secondary, qids = hub_data
    ref_hub, port_hub = _hubs(docs_a, docs_b, ids)
    want = ref.run_bilingual_vector_mix(ref_hub, qids, primary, secondary, ALPHAS, tmp_path / "ref",
                                        k=30, query_block=4)
    got = port.run_bilingual_vector_mix(port_hub, qids, primary, secondary, ALPHAS, tmp_path / "port",
                                        k=30, query_block=4)
    assert list(got) == list(want) == ALPHAS
    for a in ("0", "0.25", "0.5", "1"):
        _same_files(tmp_path / "ref", tmp_path / "port", [f"cm-alpha-{a}_raw.trec", f"cm-alpha-{a}_base.trec"])
        _same_meta(tmp_path / "ref", tmp_path / "port", f"cm-alpha-{a}_meta.json")


def test_fused_runs_are_byte_identical_and_prefix_the_unfused(hub_data, tmp_path):
    docs_a, docs_b, ids, rel, primary, secondary, qids = hub_data
    ref_hub, port_hub = _hubs(docs_a, docs_b, ids)
    qrels = {q: {ids[r]: 1, "unindexed": 1} for q, r in zip(qids, rel)}
    qrels["q-absent"] = {ids[0]: 1}
    want, want_m = ref.run_bilingual_vector_mix_fused(ref_hub, qids, primary, secondary, ALPHAS, tmp_path / "ref",
                                                      k=25, qrels=qrels)
    got, got_m = port.run_bilingual_vector_mix_fused(port_hub, qids, primary, secondary, ALPHAS,
                                                     tmp_path / "port", k=25, qrels=qrels, query_block=4)
    assert [p.name for p in got.values()] == [p.name for p in want.values()]
    assert sorted(got_m) == sorted(want_m)
    for label in want_m:
        assert sorted(got_m[label]) == sorted(want_m[label])
        for name, v in want_m[label].items():
            assert got_m[label][name] == pytest.approx(v, abs=1e-4), (label, name)
    assert got_m["1"]["RR@10"] > 50 > got_m["0"]["RR@10"]  # alpha = 1 finds the planted rows
    for a in ("0", "0.25", "0.5", "1"):
        _same_files(tmp_path / "ref", tmp_path / "port", [f"cm-alpha-{a}_base.trec"])
        _same_meta(tmp_path / "ref", tmp_path / "port", f"cm-alpha-{a}_meta.json")
        assert not (tmp_path / "port" / f"cm-alpha-{a}_raw.trec").exists()
    # the unfused collapse over a raw top-k is a prefix of the fused run
    unfused = port.run_bilingual_vector_mix(port_hub, qids, primary, secondary, [0.5], tmp_path / "u", k=25,
                                            query_block=4)
    fused_lines = (tmp_path / "port" / "cm-alpha-0.5_base.trec").read_text().splitlines()
    by_q = {}
    for ln in fused_lines:
        by_q.setdefault(ln.split()[0], []).append(ln.split()[2:5:2])
    for q, rows in _by_qid(unfused[0.5]).items():
        assert [r[1] for r in rows] == [r[1] for r in by_q[q][: len(rows)]]
        assert {r[0] for r in rows} <= {r[0] for r in by_q[q]}


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_fused_and_unfused_hub_runs_over_float_stores_match_jax(hub_data, tmp_path, dtype):
    """The hub of two f32 (f16) stores: fused and unfused vector-mix runs
    with the JAX package's lines, printed scores within one unit of the 6th
    decimal (f32 products of f32 rows round, so the two summation orders
    may differ in the last bit), metrics within 1e-4."""
    docs_a, docs_b, ids, rel, primary, secondary, qids = hub_data
    ref_hub, port_hub = _hubs(docs_a, docs_b, ids, dtype=dtype)
    assert port_hub._docs_dev[0].dtype == getattr(torch, dtype)
    qrels = {q: {ids[r]: 1} for q, r in zip(qids, rel)}
    _, want_m = ref.run_bilingual_vector_mix_fused(ref_hub, qids, primary, secondary, ALPHAS, tmp_path / "ref_f",
                                                   k=25, qrels=qrels)
    _, got_m = port.run_bilingual_vector_mix_fused(port_hub, qids, primary, secondary, ALPHAS,
                                                   tmp_path / "port_f", k=25, qrels=qrels, query_block=4)
    for label in want_m:
        for name, v in want_m[label].items():
            assert got_m[label][name] == pytest.approx(v, abs=1e-4), (label, name)
    assert got_m["1"]["RR@10"] > 50
    for name, mod, hub in (("ref", ref, ref_hub), ("port", port, port_hub)):
        mod.run_bilingual_vector_mix(hub, qids, primary, secondary, ALPHAS, tmp_path / name, k=25, query_block=4)
    for a in ("0", "0.25", "0.5", "1"):
        _assert_close_runs(tmp_path / "ref_f" / f"cm-alpha-{a}_base.trec",
                           tmp_path / "port_f" / f"cm-alpha-{a}_base.trec")
        for suffix in ("_raw", "_base"):
            _assert_close_runs(tmp_path / "ref" / f"cm-alpha-{a}{suffix}.trec",
                               tmp_path / "port" / f"cm-alpha-{a}{suffix}.trec")


def _assert_close_runs(ref_path, port_path):
    """The same (qid, docid, rank) lines; printed scores within one unit of
    the 6th decimal (one f32 ulp apart before printing)."""
    want = [ln.split() for ln in pathlib.Path(ref_path).read_text().splitlines()]
    got = [ln.split() for ln in pathlib.Path(port_path).read_text().splitlines()]
    assert [g[:4] + g[5:] for g in got] == [w[:4] + w[5:] for w in want]
    np.testing.assert_allclose([float(g[4]) for g in got], [float(w[4]) for w in want], rtol=0, atol=1.001e-6)


def _dense_runs(tmp_path, seed):
    """Both packages' unfused and fused vector-mix runs over a hub of dense
    rows; returns the (ref, port) path pairs of every TREC file."""
    docs_a, docs_b, ids, rel, primary, secondary, qids = _hub(sparse=False, seed=seed)
    ref_hub, port_hub = _hubs(docs_a, docs_b, ids)
    for name, mod, hub in (("ref", ref, ref_hub), ("port", port, port_hub)):
        mod.run_bilingual_vector_mix(hub, qids, primary, secondary, ALPHAS, tmp_path / name, k=30, query_block=4)
        mod.run_bilingual_vector_mix_fused(hub, qids, primary, secondary, ALPHAS, tmp_path / f"{name}_f", k=30)
    return [(tmp_path / f"ref{sub}" / f"cm-alpha-{a}{suffix}.trec", tmp_path / f"port{sub}" / f"cm-alpha-{a}{suffix}.trec")
            for a in ("0", "0.25", "0.5", "1")
            for sub, suffixes in (("", ("_raw", "_base")), ("_f", ("_base",)))
            for suffix in suffixes]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 7])
def test_dense_rows_give_the_same_runs_up_to_the_last_printed_digit(tmp_path, seed):
    for want, got in _dense_runs(tmp_path, seed):
        _assert_close_runs(want, got)


@pytest.mark.xfail(
    strict=True, raises=AssertionError,
    reason="on the CPU torch's matmul and XLA's dot sum a dense row's 32 products in different "
           "orders: a few percent of the f32 scores differ by one ulp, and 11 of the 3,182 lines "
           "of this seed's runs print a different 6th decimal (ids and ranks all equal)",
)
def test_dense_row_runs_are_byte_identical(tmp_path):
    for want, got in _dense_runs(tmp_path, 0):
        assert got.read_bytes() == want.read_bytes(), got.name


def _by_qid(path):
    out = {}
    for ln in pathlib.Path(path).read_text().splitlines():
        f = ln.split()
        out.setdefault(f[0], []).append((f[2], f[4]))
    return out


def test_validate_parallel_hub_refuses_other_hubs(hub_data, tmp_path):
    docs_a, docs_b, ids, *_ = hub_data
    _, port_hub = _hubs(docs_a, docs_b, ids)
    assert port.validate_parallel_hub(port_hub) == len(ids)
    _, shuffled = _hubs(docs_a, docs_b, ids, ids[::-1])
    with pytest.raises(ValueError, match="mirrored"):
        port.validate_parallel_hub(shuffled)
    odd = PortIndex.merged([PortIndex.build(docs_a, ids), PortIndex.build(docs_b[:-1], ids[:-1])])
    with pytest.raises(ValueError, match="odd row count"):
        port.validate_parallel_hub(odd)
    with pytest.raises(ValueError, match="mirrored"):
        port.run_bilingual_vector_mix_fused(shuffled, ["q"], docs_a[:1], docs_a[:1], [0.5], tmp_path)


def _token_pair(tmp_path, lang, seed):
    """A dense index and a token store over the same 48 docs."""
    rng = np.random.default_rng(seed)
    n, td, d = 48, 8, 32
    toks = _unit(rng.standard_normal((n, td, d)))
    lens = rng.integers(1, td + 1, size=n)
    toks *= (np.arange(td)[None] < lens[:, None])[..., None]
    dense = _unit(toks.sum(axis=1))
    ids = [f"d{i}" for i in range(n)]
    w = PortWriter(tmp_path / lang / "tok", token_dim=d, tokens_per_doc=td)
    w.append(toks, lens, ids)
    w.finalize()
    ref_ix = RefIndex.build(dense, ids, lang=lang).to_device(make_mesh(shard=1, tp=1), pad_multiple=64)
    port_ix = PortIndex.build(dense, ids, lang=lang).to_device("cpu", pad_multiple=64)
    return ref_ix, port_ix, tmp_path / lang / "tok"


def test_two_stage_bilingual_runs_are_byte_identical(tmp_path):
    pairs = [_token_pair(tmp_path, "en", 1), _token_pair(tmp_path, "zh", 2)]
    rng = np.random.default_rng(3)
    q_toks = _unit(rng.standard_normal((5, 4, 32)))
    q_lens = np.array([4, 2, 3, 1, 4])
    q_toks *= (np.arange(4)[None] < q_lens[:, None])[..., None]
    q_dense = _unit(q_toks.sum(axis=1))
    qids = [f"q{i}" for i in range(5)]
    save_query_token_cache(tmp_path / "cache" / "cm50.npz", qids, q_dense, q_toks, q_lens)
    sets = {"cm50": [(q, "unused") for q in qids]}
    common = dict(k=6, k_dense=12, cache_root=tmp_path / "cache")
    want = ref_rerank.run_two_stage_bilingual([p[0] for p in pairs], [RefTokens.open(p[2]) for p in pairs],
                                              None, sets, tmp_path / "ref", **common)
    got = port_rerank.run_two_stage_bilingual([p[1] for p in pairs], [PortTokens.open(p[2]) for p in pairs],
                                              None, sets, tmp_path / "port", **common)
    assert got["cm50"].name == want["cm50"].name == "cm50_base.trec"
    _same_files(tmp_path / "ref", tmp_path / "port", ["cm50_raw.trec", "cm50_base.trec"])
    assert json.loads((tmp_path / "port" / "cm50_meta.json").read_text()) == json.loads(
        (tmp_path / "ref" / "cm50_meta.json").read_text())


# ---------------------------------------------------------------------------
# CLI, smoke mode on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def cli_tree(tmp_path):
    """Two parallel per-language stores at --smoke_dim 32, query TSVs, qrels."""
    rng = np.random.default_rng(5)
    docs = _unit(rng.standard_normal((300, 32)))
    ids = [f"d{i}" for i in range(300)]
    PortIndex.build(docs, ids, lang="en").save(tmp_path / "en")
    PortIndex.build(_unit(docs + 0.3 * rng.standard_normal((300, 32))), ids, lang="zh").save(tmp_path / "zh")
    write_queries_tsv(tmp_path / "a.tsv", [(f"q{i}", f"english query {i}") for i in range(5)])
    write_queries_tsv(tmp_path / "b.tsv", [(f"q{i}", f"中文 查询 {i}") for i in range(5)])
    (tmp_path / "qrels.tsv").write_text("".join(f"q{i}\td{i}\t1\n" for i in range(5)))
    return tmp_path


def _cli(capsys, argv):
    from codemix_dense_retrieval_torch.cli import main

    capsys.readouterr()
    main(argv)
    return json.loads(capsys.readouterr().out)


def test_cli_run_bilingual_and_bilingual_mix(cli_tree, capsys):
    t = cli_tree
    hub = ["--device", "cpu", "--smoke_dim", "32", "--index", str(t / "en"), str(t / "zh")]
    runs = _cli(capsys, ["run-bilingual", *hub, "--queries", str(t / "a.tsv"), "--outdir", str(t / "wm"),
                         "--k", "20"])
    assert list(runs) == ["a"] and (t / "wm" / "a_raw.trec").exists()
    assert len((t / "wm" / "a_raw.trec").read_text().splitlines()) == 5 * 20
    assert "#zh" in (t / "wm" / "a_raw.trec").read_text()
    mix = ["run-bilingual-mix", *hub, "--query_tsv", f"en={t / 'a.tsv'}", f"zh={t / 'b.tsv'}",
           "--cm_alphas", "0", "0.5", "1", "--k", "20"]
    runs = _cli(capsys, [*mix, "--outdir", str(t / "vm")])
    assert sorted(pathlib.Path(p).name for p in runs.values()) == [
        "cm-alpha-0.5_base.trec", "cm-alpha-0_base.trec", "cm-alpha-1_base.trec"]
    fused = _cli(capsys, [*mix, "--outdir", str(t / "vmf"), "--fused", "--qrels", str(t / "qrels.tsv")])
    assert sorted(fused) == ["0.0", "0.5", "1.0"]
    assert {"run", "RR@10", "nDCG@10", "AP"} <= set(fused["0.5"])
    assert len((t / "vmf" / "cm-alpha-0.5_base.trec").read_text().splitlines()) == 5 * 20
    with pytest.raises(SystemExit, match="does not support --approx adaptive"):
        _cli(capsys, [*mix, "--outdir", str(t / "x"), "--fused", "--approx", "adaptive"])


def test_cli_bilingual_mix_fused_refuses_a_non_parallel_hub(cli_tree, capsys):
    t = cli_tree
    rng = np.random.default_rng(6)
    PortIndex.build(_unit(rng.standard_normal((300, 32))), [f"e{i}" for i in range(300)], lang="zh").save(t / "zz")
    with pytest.raises(SystemExit, match="parallel hub.*mirrored"):
        _cli(capsys, ["run-bilingual-mix", "--device", "cpu", "--smoke_dim", "32", "--index", str(t / "en"),
                      str(t / "zz"), "--query_tsv", f"en={t / 'a.tsv'}", f"zh={t / 'b.tsv'}",
                      "--outdir", str(t / "o"), "--fused"])


@pytest.mark.parametrize("approx", ["off", "guaranteed"])
def test_cli_run_mix_fused_with_qrels(cli_tree, capsys, approx):
    t = cli_tree
    argv = ["run-mix", "--device", "cpu", "--smoke_dim", "32", "--index", str(t / "en"),
            "--query_tsv", f"en={t / 'a.tsv'}", f"zh={t / 'b.tsv'}", "--cm_alphas", "0", "0.5", "1",
            "--k", "10", "--approx", approx]
    fused = _cli(capsys, [*argv, "--outdir", str(t / "f"), "--fused", "--qrels", str(t / "qrels.tsv")])
    assert sorted(fused) == ["0", "0.5", "1"]
    assert {"run", "RR@10", "P@1", "AP"} <= set(fused["0.5"])
    assert ("certified_frac" in fused["0"]) == (approx != "off")
    _cli(capsys, [*argv, "--outdir", str(t / "u")])
    for a in ("0", "0.5", "1"):
        assert (t / "f" / f"cm-alpha-{a}.trec").read_bytes() == (t / "u" / f"cm-alpha-{a}.trec").read_bytes()


def test_cli_run_rerank_over_two_indexes(tmp_path, capsys):
    corpus = tmp_path / "c.tsv"
    corpus.write_text("".join(f"d{i}\tpassage {i} about topic {i % 5} words w{i}\n" for i in range(30)))
    corpus2 = tmp_path / "c2.tsv"
    corpus2.write_text("".join(f"d{i}\t段落 {i} 主题 {i % 3}\n" for i in range(20)))
    queries = tmp_path / "cm50.tsv"
    queries.write_text("".join(f"q{i}\ttopic {i} query\n" for i in range(4)))
    _cli_plain = ["--device", "cpu", "--smoke_dim", "32"]
    from codemix_dense_retrieval_torch.cli import main

    main(["encode-corpus", *_cli_plain, "--corpus_tsv", f"en={corpus}", f"zh={corpus2}",
          "--out", str(tmp_path / "ix"), "--storage_dtype", "int8", "--tokens_per_doc", "8",
          "--batch", "16", "--enc_batch", "8"])
    runs = _cli(capsys, ["run-rerank", *_cli_plain, "--index", str(tmp_path / "ix" / "en"),
                         str(tmp_path / "ix" / "zh"), "--queries", str(queries), "--outdir",
                         str(tmp_path / "runs"), "--k", "5", "--k_dense", "12"])
    assert list(runs) == ["cm50"] and pathlib.Path(runs["cm50"]).name == "cm50_base.trec"
    raw = (tmp_path / "runs" / "cm50_raw.trec").read_text().splitlines()
    assert len(raw) == 4 * 5
    meta = json.loads((tmp_path / "runs" / "cm50_meta.json").read_text())
    assert meta["n_queries"] == 4 and meta["k_dense_effective"] == 12
