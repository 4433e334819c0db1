"""pipeline/runs.py + evals/: the vector-mix run writes byte-identical TREC
files in both packages for the same vectors, the port's evaluator gives the
same -agg.json numbers, and the port's CLI runs end to end in smoke mode on
the CPU."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from codemix_dense_retrieval_torch.evals import evaluate as port_eval
from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex as PortIndex
from codemix_dense_retrieval_torch.io.tsv import write_queries_tsv
from codemix_dense_retrieval_torch.pipeline import runs as port_runs
from codemix_dense_retrieval_tpu.evals import evaluate as ref_eval
from codemix_dense_retrieval_tpu.index.flat import DenseFlatIndex as RefIndex
from codemix_dense_retrieval_tpu.parallel.mesh import make_mesh
from codemix_dense_retrieval_tpu.pipeline import runs as ref_runs

REPO = pathlib.Path(__file__).resolve().parents[1]
ALPHAS = [0.0, 0.25, 0.5, 0.75, 1.0]


@pytest.fixture(scope="module")
def mix_runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    n, d, b = 2500, 32, 12
    docs = rng.standard_normal((n, d)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    ids = [f"doc{i}" for i in range(n)]
    primary = rng.standard_normal((b, d)).astype(np.float32)
    secondary = primary + 0.5 * rng.standard_normal((b, d)).astype(np.float32)
    qids = [f"q{i}" for i in range(b)]
    root = tmp_path_factory.mktemp("runs")
    ref_index = RefIndex.build(docs, ids).to_device(make_mesh(shard=1, tp=1))
    port_index = PortIndex.build(docs, ids).to_device("cpu")
    ref_paths = ref_runs.run_vector_mix_search(
        ref_index, qids, primary, secondary, ALPHAS, root / "ref", k=50, query_block=8)
    port_paths = port_runs.run_vector_mix_search(
        port_index, qids, primary, secondary, ALPHAS, root / "port", k=50, query_block=8)
    return root, ref_paths, port_paths, qids, ids


@pytest.mark.parametrize("alpha", ALPHAS)
def test_vector_mix_trec_files_are_byte_identical(mix_runs, alpha):
    _, ref_paths, port_paths, qids, _ = mix_runs
    assert port_paths[alpha].name == ref_paths[alpha].name
    got = port_paths[alpha].read_bytes()
    assert got == ref_paths[alpha].read_bytes()
    assert len(got.splitlines()) == len(qids) * 50


def test_evaluate_agg_json_matches(mix_runs, tmp_path):
    root, _, port_paths, qids, ids = mix_runs
    rng = np.random.default_rng(1)
    qrels = tmp_path / "qrels.tsv"
    qrels.write_text("".join(
        f"{q}\t{ids[j]}\t{int(r)}\n"
        for q in qids for j, r in zip(rng.choice(len(ids), 20, replace=False), rng.integers(0, 3, 20))
    ) + f"{qids[0]}\tdoc0\t1\n")
    run = port_paths[0.5]
    port_eval.main(["--dataset", "x", "--run", str(run), "--qrels", str(qrels),
                    "--outdir", str(tmp_path / "port"), "--perquery"])
    ref_eval.main(["--dataset", "x", "--run", str(run), "--qrels", str(qrels),
                   "--outdir", str(tmp_path / "ref"), "--perquery"])
    (got_path,) = (tmp_path / "port").glob("*-agg.json")
    (want_path,) = (tmp_path / "ref").glob("*-agg.json")
    got, want = json.loads(got_path.read_text()), json.loads(want_path.read_text())
    assert list(got) == list(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=0, rel=0, nan_ok=True), key
    assert (tmp_path / "port" / got_path.name.replace("-agg.json", "-perquery.csv")).exists()


def _nan_and_missing_cells():
    """Hand-made metrics: a NaN aggregate, a negative zero, an int, and
    per-query rows where one query lacks a metric (an empty cell)."""
    ordered = {"nDCG@10": 12.345678901234567, "RR@10": float("nan"), "P@1": -0.0, "R@100": 100.0,
               "n": 3}
    rows = [("q2", "RR@10", 50.0), ("q2", "nDCG@10", 1 / 3), ("q10", "nDCG@10", 0.0),
            ("q1", "RR@10", float("nan")), ("q1", "nDCG@10", 1e-05)]
    diag = {"num_queries": 3, "pct_unjudged": 12.5}
    return ordered, rows, diag, ["RR@10", "nDCG@10"]


def _empty_evaluation():
    ordered, rows, diag = port_eval.evaluate_run({}, {}, perquery=True)
    return ordered, rows, diag, None


@pytest.mark.parametrize("make", [_nan_and_missing_cells, _empty_evaluation])
def test_evaluate_artifacts_are_byte_identical(make, tmp_path):
    ordered, rows, diag, names = make()
    run = pathlib.Path("runs/cm-alpha-0.5.trec")
    got = port_eval.write_artifacts(ordered, rows, diag, run, "dev", tmp_path / "port",
                                    metric_names=names, timestamp="20260101-000000")
    want = ref_eval.write_artifacts(ordered, rows, diag, run, "dev", tmp_path / "ref",
                                    metric_names=names, timestamp="20260101-000000")
    assert got.name == want.name
    written = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == written
    assert len(written) == (4 if rows else 3)
    for name in written:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes(), name


def test_docid_table_follows_add_remove_and_rebalance(tmp_path):
    """A vector-mix sweep after each add / remove / rebalance of a two-shard
    index writes, on every line, the docid its search's row id names then;
    traced, each state of the index builds the docid table once and each
    alpha writes through it."""
    import torch

    from codemix_dense_retrieval_torch.ops.mix import mix_and_renorm
    from codemix_dense_retrieval_torch.parallel.mesh import make_mesh as port_mesh
    from codemix_dense_retrieval_torch.utils import timing

    rng = np.random.default_rng(11)
    n, d, b, k, alphas = 600, 32, 6, 9, [0.0, 0.5, 1.0]
    unit = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    index = PortIndex.build(unit(rng.standard_normal((n, d))), [f"d{i}" for i in range(n)]).to_device(
        port_mesh(shard=2, devices=["cpu"] * 2), pad_multiple=128)
    qids = [f"q{i}" for i in range(b)]
    primary = rng.standard_normal((b, d)).astype(np.float32)
    secondary = primary + 0.5 * rng.standard_normal((b, d)).astype(np.float32)
    steps = [("initial", lambda: None),
             ("add", lambda: index.add(unit(rng.standard_normal((40, d))), [f"new{i}" for i in range(40)])),
             ("remove", lambda: index.remove([f"d{i}" for i in range(0, 300, 3)] + ["new0", "new7"])),
             ("rebalance", index.rebalance)]
    timing.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for name, step in steps:
                step()
                paths = port_runs.run_vector_mix_search(index, qids, primary, secondary, alphas,
                                                        tmp_path / name, k=k, query_block=4)
                for alpha in alphas:
                    q = mix_and_renorm(torch.from_numpy(primary), torch.from_numpy(secondary), alpha)
                    _, gid = index.search(q, k, return_docids=False, query_block=4)
                    got = [line.split("\t")[2] for line in paths[alpha].read_text().splitlines()]
                    assert got == [str(x) for x in index.docids[gid].ravel()], (name, alpha)
                    assert None not in index.docids[gid]
        counters = timing.totals()["counters"]
    finally:
        timing.reset()
    assert index.count == n + 40 - 102
    assert counters["trec.table_builds"] == len(steps)
    assert counters["trec.table_writes"] == len(steps) * len(alphas)


def test_intersect_query_sets_matches():
    a = [("1", "x"), ("2", "y"), ("3", "z")]
    b = [("3", "Z"), ("1", "X"), ("9", "?")]
    assert port_runs.intersect_query_sets(a, b) == ref_runs.intersect_query_sets(a, b)


def test_cli_run_mix_smoke_on_cpu(tmp_path):
    rng = np.random.default_rng(2)
    docs = rng.standard_normal((300, 32)).astype(np.float32)
    PortIndex.build(docs, [f"d{i}" for i in range(300)]).save(tmp_path / "ix")
    write_queries_tsv(tmp_path / "en.tsv", [(f"q{i}", f"english query {i}") for i in range(5)])
    write_queries_tsv(tmp_path / "zh.tsv", [(f"q{i}", f"中文 查询 {i}") for i in range(1, 6)])
    out = subprocess.run(
        [sys.executable, "-m", "codemix_dense_retrieval_torch", "run-mix", "--device", "cpu",
         "--index", str(tmp_path / "ix"), "--smoke_dim", "32", "--k", "7",
         "--query_tsv", f"en={tmp_path / 'en.tsv'}", f"zh={tmp_path / 'zh.tsv'}",
         "--cm_alphas", "0", "0.5", "1", "--outdir", str(tmp_path / "runs"),
         "--query_cache", str(tmp_path / "cache")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    paths = json.loads(out.stdout)
    assert sorted(pathlib.Path(p).name for p in paths.values()) == [
        "cm-alpha-0.5.trec", "cm-alpha-0.trec", "cm-alpha-1.trec"]
    lines = (tmp_path / "runs" / "cm-alpha-0.5.trec").read_text().splitlines()
    assert len(lines) == 4 * 7  # qids 1..4 are common to both TSVs
    assert (tmp_path / "cache" / "en" / "queries.npz").exists()


@pytest.mark.parametrize("flag", [["--shards", "2", "--weight_quant", "int8"], ["--dp", "2", "--weight_quant", "nf4"],
                                  ["--shards", "2"], ["--dp", "2"]])
def test_cli_refuses_unported_options(tmp_path, flag):
    """``--shards`` and ``--dp`` are ported: on ``--device cpu`` they run
    (2 CPU shards, 2 data-parallel chunks) and write the one-device runs."""
    from codemix_dense_retrieval_torch.cli import main

    rng = np.random.default_rng(4)
    PortIndex.build(rng.standard_normal((600, 32)).astype(np.float32), [f"d{i}" for i in range(600)]).save(
        tmp_path / "ix")
    write_queries_tsv(tmp_path / "en.tsv", [(f"q{i}", f"english text {i}") for i in range(5)])
    write_queries_tsv(tmp_path / "zh.tsv", [(f"q{i}", f"中文 {i}") for i in range(5)])
    common = ["run-mix", "--device", "cpu", "--index", str(tmp_path / "ix"), "--smoke_dim", "32", "--k", "7",
              "--query_tsv", f"en={tmp_path / 'en.tsv'}", f"zh={tmp_path / 'zh.tsv'}", "--cm_alphas", "0.5"]
    main(common + ["--outdir", str(tmp_path / "one")])
    main(common + ["--outdir", str(tmp_path / "mesh"), *flag])
    got = (tmp_path / "mesh" / "cm-alpha-0.5.trec").read_bytes()
    assert len(got.splitlines()) == 5 * 7 and got == (tmp_path / "one" / "cm-alpha-0.5.trec").read_bytes()


def test_word_mix_runner_matches_jax(tmp_path):
    import jax

    from codemix_dense_retrieval_torch.models.encoder import TextEncoder as PortEncoder
    from codemix_dense_retrieval_torch.models.xlmr import XLMRConfig as PortCfg
    from codemix_dense_retrieval_tpu.models.encoder import TextEncoder as RefEncoder
    from codemix_dense_retrieval_tpu.models.xlmr import XLMRConfig as RefCfg

    tiny = dict(vocab_size=500, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                max_position_embeddings=66)
    ref_enc = RefEncoder("BAAI/bge-m3", RefCfg.tiny(**tiny, use_flash=False), seed=3)
    params = jax.tree_util.tree_map(np.asarray, ref_enc.params)
    port_enc = PortEncoder("BAAI/bge-m3", PortCfg.tiny(**tiny, use_flash=False), params, device="cpu")
    rng = np.random.default_rng(5)
    docs = rng.standard_normal((1500, 32)).astype(np.float32)
    ids = [f"p{i}" for i in range(1500)]
    sets = {"cm0-20": [(f"q{i}", f"query words {i} {i * 7}") for i in range(9)],
            "cm80-100": [(f"q{i}", f"中文 {i}") for i in range(6)]}
    ref_paths = ref_runs.run_word_mix_search(
        RefIndex.build(docs, ids).to_device(make_mesh(shard=1, tp=1)), ref_enc, sets, tmp_path / "ref", k=20)
    port_paths = port_runs.run_word_mix_search(
        PortIndex.build(docs, ids).to_device("cpu"), port_enc, sets, tmp_path / "port", k=20)
    for name in sets:
        got = [line.split("\t") for line in port_paths[name].read_text().splitlines()]
        want = [line.split("\t") for line in ref_paths[name].read_text().splitlines()]
        assert [r[:4] + r[5:] for r in got] == [r[:4] + r[5:] for r in want]
        np.testing.assert_allclose([float(r[4]) for r in got], [float(r[4]) for r in want], atol=2e-4)


def test_query_cache_is_shared_with_jax(tmp_path):
    from codemix_dense_retrieval_torch.pipeline import query_cache as port_qc
    from codemix_dense_retrieval_tpu.pipeline import query_cache as ref_qc

    vecs = np.random.default_rng(6).standard_normal((3, 8)).astype(np.float32)
    port_qc.save_query_cache(tmp_path / "a" / "queries.npz", ["x", "y", "z"], vecs)
    qids, got = ref_qc.load_query_cache(tmp_path / "a" / "queries.npz", expected_qids=["x", "y", "z"])
    np.testing.assert_array_equal(got, vecs)
    ref_qc.save_query_cache(tmp_path / "b" / "queries.npz", ["x", "y", "z"], vecs)
    qids, got = port_qc.load_query_cache(tmp_path / "b" / "queries.npz", expected_qids=["x", "y", "z"])
    np.testing.assert_array_equal(got, vecs)
    with pytest.raises(port_qc.QueryCacheMismatch):
        port_qc.load_query_cache(tmp_path / "b" / "queries.npz", expected_qids=["x", "y"])


def test_cli_run_mono_smoke_on_cpu(tmp_path):
    rng = np.random.default_rng(7)
    docs = rng.standard_normal((200, 32)).astype(np.float32)
    PortIndex.build(docs, [f"d{i}" for i in range(200)]).save(tmp_path / "ix")
    bands = tmp_path / "bands"
    write_queries_tsv(bands / "queries-cm0-20.tsv", [(f"q{i}", f"band query {i}") for i in range(4)])
    write_queries_tsv(bands / "queries-cm20-40.tsv", [(f"q{i}", f"другой {i}") for i in range(3)])
    out = subprocess.run(
        [sys.executable, "-m", "codemix_dense_retrieval_torch", "run-mono", "--device", "cpu",
         "--index", str(tmp_path / "ix"), "--smoke_dim", "32", "--k", "5",
         "--queries", str(bands), "--outdir", str(tmp_path / "runs")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert sorted(json.loads(out.stdout)) == ["cm0-20", "cm20-40"]
    assert len((tmp_path / "runs" / "cm20-40.trec").read_text().splitlines()) == 15


def test_cli_streams_queries_from_a_dataset_repo(tmp_path, monkeypatch):
    """--queries_repo reads an HF streaming split, as the JAX CLI does; a
    stand-in ``datasets`` module serves the split here."""
    import types

    from codemix_dense_retrieval_torch.cli import build_parser, main

    seen = {}

    def load_dataset(repo, config, split, streaming):
        seen.update(repo=repo, config=config, split=split, streaming=streaming)
        return iter([{"qid": 10 + i, "q": f"streamed query {i}"} for i in range(5)])

    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(load_dataset=load_dataset))
    rng = np.random.default_rng(8)
    PortIndex.build(rng.standard_normal((50, 32)).astype(np.float32), [f"d{i}" for i in range(50)]).save(
        tmp_path / "ix")
    flags = ["--queries_repo", "org/queries", "--queries_config", "hindi", "--queries_split", "dev",
             "--qid_field", "qid", "--qtext_field", "q", "--max_queries", "3"]
    main(["run-mono", "--device", "cpu", "--index", str(tmp_path / "ix"), "--smoke_dim", "32", "--k", "4",
          "--outdir", str(tmp_path / "runs"), *flags])
    assert seen == dict(repo="org/queries", config="hindi", split="dev", streaming=True)
    lines = (tmp_path / "runs" / "hindi.trec").read_text().splitlines()
    assert sorted({ln.split()[0] for ln in lines}) == ["10", "11", "12"] and len(lines) == 12
    # run-rerank takes the same query flags
    args = build_parser().parse_args(["run-rerank", "--index", "x", "--outdir", "o", *flags])
    assert (args.queries_repo, args.qid_field, args.qtext_field) == ("org/queries", "qid", "q")
    monkeypatch.setitem(sys.modules, "datasets", None)  # not installed
    with pytest.raises(SystemExit, match="needs the `datasets` package"):
        main(["run-mono", "--device", "cpu", "--index", str(tmp_path / "ix"), "--smoke_dim", "32",
              "--outdir", str(tmp_path / "runs2"), *flags])
