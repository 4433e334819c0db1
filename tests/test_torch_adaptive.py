"""The adaptive probed-exact tier: ops/topk.py's probed cover and escalation
tail, parallel/sharded_search.py's sharded_topk_ip_adaptive,
ops/sketch.py's cluster_bisect_order and index/flat.py's reorder_rows,
calibrate_adaptive and approx="adaptive", against the JAX package on the
same numpy inputs (one-shard mesh, Pallas in interpret mode) and against
the port's own exact search.

Tolerances: on the CPU torch's matmul and XLA's dot sum a row's products in
another order, so values agree within 1e-5, and a query whose k-th score
lies within 1e-5 of its unselected-bin bound may certify in one package and
not the other: such queries are left out of the certificate comparison (the
tests count them). Ids are compared exactly. ``cluster_bisect_order`` is the
same numpy code and ``reorder_rows`` projects on the host as the JAX package
does, so permutations are equal.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.index import flat as port_flat
from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex as PortIndex
from codemix_dense_retrieval_torch.ops import sketch as port_sketch
from codemix_dense_retrieval_torch.ops import topk as port
from codemix_dense_retrieval_torch.parallel.sharded_search import (
    sharded_topk_ip,
    sharded_topk_ip_adaptive,
)
from codemix_dense_retrieval_tpu.index.flat import DenseFlatIndex as RefIndex
from codemix_dense_retrieval_tpu.ops import sketch as ref_sketch
from codemix_dense_retrieval_tpu.ops import topk as ref
from codemix_dense_retrieval_tpu.parallel import make_mesh, shard_rows
from codemix_dense_retrieval_tpu.parallel.sharded_search import sharded_topk_ip_adaptive as ref_adaptive

TOL = 1e-5


def _normalize(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered_corpus(rng, n, d, b, k, frac_easy=0.5):
    """The JAX suite's corpus: a planted, contiguous, well-separated top
    block for ``frac_easy`` of the queries (they certify at small probes),
    uniform rows for the rest."""
    docs = _normalize(rng.standard_normal((n, d)).astype(np.float32)) * 0.1
    qs = _normalize(rng.standard_normal((b, d)).astype(np.float32))
    n_easy = int(b * frac_easy)
    for i in range(n_easy):
        dirs = qs[i] + 0.05 * rng.standard_normal((2 * k, d)).astype(np.float32)
        docs[i * 2 * k : (i + 1) * 2 * k] = _normalize(dirs)
    return docs, qs, n_easy


def _clustered_rows(rng, n, d, centers=16):
    """Unit rows around ``centers`` unit centres, in random order (the
    chip run's recipe at a small size)."""
    c = _normalize(rng.standard_normal((centers, d)).astype(np.float32))
    a = rng.integers(0, centers, n)
    return _normalize(c[a] + 0.35 / np.sqrt(d) * rng.standard_normal((n, d)).astype(np.float32)), c


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _mesh():
    return make_mesh(shard=1, tp=1)


@pytest.mark.parametrize("seed,n,d,b,k,probe", [(0, 4096, 48, 24, 64, 16), (1, 2048, 32, 16, 40, 12)])
def test_probed_cover_matches_jax(seed, n, d, b, k, probe):
    rng = np.random.default_rng(seed)
    docs, qs, n_easy = _clustered_corpus(rng, n, d, b, k)
    rv, ri, rc, ru, rs, rb = ref.topk_ip_bins_two_level_probed(
        jnp.asarray(qs), jnp.asarray(docs), k, probe_bins=probe, bin_size=8, tile_n=256,
        interpret=True, keep_scores=True,
    )
    pv, pi, pc, pu, ps, pb = port.topk_ip_bins_two_level_probed(
        _t(qs), _t(docs), k, probe_bins=probe, bin_size=8, tile_n=256, keep_scores=True,
    )
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=0, atol=TOL)
    np.testing.assert_allclose(pu.numpy(), np.asarray(ru), rtol=0, atol=TOL)
    # certificates compared where the k-th score is not within TOL of the bound
    clear = np.abs(np.asarray(rv)[:, k - 1] - np.asarray(ru)) > TOL
    np.testing.assert_array_equal(pc.numpy()[clear], np.asarray(rc)[clear])
    assert clear.sum() >= b - 2
    assert pc.numpy()[:n_easy].all()  # the planted queries certify
    # the escalation tail on the retained scores, for the uncertified rows
    bad = np.flatnonzero(~pc.numpy())
    assert len(bad)
    ev, eg = ref.topk_full_tail_bm(rs, rb, jnp.asarray(bad.astype(np.int32)), k, 8, 8)
    pev, peg = port.topk_full_tail_bm(ps, pb, _t(bad), k, 8, 8)
    np.testing.assert_array_equal(peg.numpy(), np.asarray(eg))
    np.testing.assert_allclose(pev.numpy(), np.asarray(ev), rtol=0, atol=TOL)


def test_tail_equals_the_full_two_level_tail_on_its_rows():
    rng = np.random.default_rng(2)
    docs = rng.standard_normal((2048, 32)).astype(np.float32)
    qs = rng.standard_normal((16, 32)).astype(np.float32)
    k = 50
    _, _, _, _, s, bm = port.topk_ip_bins_two_level_probed(
        _t(qs), _t(docs), k, probe_bins=k // 8 + 1, bin_size=8, tile_n=256, keep_scores=True)
    qsel = np.array([3, 0, 15, 7])
    ev, eg = port.topk_full_tail_bm(s, bm, _t(qsel), k, 8, 8)
    fv, fi = port._topk_from_bins_two_level_bm(s[qsel], bm[qsel], k, 8, 8)
    np.testing.assert_array_equal(eg.numpy(), fi.numpy())
    np.testing.assert_array_equal(ev.numpy(), fv.numpy())
    wv, wi = port.topk_ip_bins_two_level(_t(qs), _t(docs), k, bin_size=8, tile_n=256)
    np.testing.assert_array_equal(eg.numpy(), wi.numpy()[qsel])


def test_probe_too_small_raises_with_the_jax_message():
    with pytest.raises(ValueError, match="cannot hold k candidates"):
        port.topk_ip_bins_two_level_probed(torch.zeros(4, 16), torch.zeros(512, 16), 64, probe_bins=4,
                                           bin_size=8)


@pytest.mark.parametrize("frac_easy,branch", [(0.5, "tail"), (0.0, "exact"), (1.0, "none")])
def test_sharded_adaptive_matches_jax_and_exact_search(frac_easy, branch):
    """Both escalation branches (<= B/2 escalated: the tail on the retained
    scores; > B/2: exact search) and the all-certified case give the port's
    exact search's results and the JAX package's stats."""
    rng = np.random.default_rng(3)
    n, d, b, k = 8192, 48, 16, 40
    docs, qs, _ = _clustered_corpus(rng, n, d, b, k, frac_easy=frac_easy)
    ref_docs, ref_counts, _ = shard_rows(docs, _mesh(), pad_multiple=256)
    rv, rg, rstats = ref_adaptive(jnp.asarray(qs), ref_docs, ref_counts, k, mesh=_mesh(),
                                  probe_bins=10, tile_n=256, tile_b=64, interpret=True)
    pdocs = torch.zeros(ref_docs.shape[0], d)
    pdocs[:n] = _t(docs)
    counts = torch.tensor([n], dtype=torch.int32)
    pv, pg, pstats = sharded_topk_ip_adaptive(_t(qs), pdocs, counts, k, probe_bins=10, tile_n=256)
    assert pstats == rstats
    np.testing.assert_array_equal(pg.numpy(), np.asarray(rg))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=0, atol=TOL)
    ev, eg = sharded_topk_ip(_t(qs), pdocs, counts, k, tile_n=256)
    np.testing.assert_array_equal(pg.numpy(), eg.numpy())
    np.testing.assert_array_equal(pv.numpy(), ev.numpy())
    escalated = pstats.get("escalated", 0)
    assert {"tail": 0 < escalated <= b // 2, "exact": escalated > b // 2, "none": escalated == 0}[branch]


def test_sharded_adaptive_refuses_int8_and_pad_rows_never_win():
    rng = np.random.default_rng(4)
    dv = rng.integers(-127, 127, (4096, 32)).astype(np.int8)
    with pytest.raises(NotImplementedError, match="int8"):
        sharded_topk_ip_adaptive(torch.zeros(4, 32), _t(dv), torch.tensor([4096], dtype=torch.int32), 16)
    # all-negative scores: zero pad rows would outrank every real row
    docs = -np.abs(rng.standard_normal((6000, 32)).astype(np.float32))
    qs = np.abs(rng.standard_normal((8, 32)).astype(np.float32))
    pdocs = torch.zeros(6144, 32)
    pdocs[:6000] = _t(docs)
    _, pg, _ = sharded_topk_ip_adaptive(_t(qs), pdocs, torch.tensor([6000], dtype=torch.int32), 32,
                                        probe_bins=6, tile_n=256)
    want = np.argsort(-(qs @ docs.T), axis=1, kind="stable")[:, :32]
    np.testing.assert_array_equal(pg.numpy(), want)


@pytest.mark.parametrize("n,ds,seed", [(5, 8, 0), (8, 8, 1), (1000, 16, 2), (4099, 32, 3), (3000, 48, 4)])
def test_cluster_bisect_order_equals_jax(n, ds, seed):
    sk = np.random.default_rng(seed).standard_normal((n, ds)).astype(np.float32)
    sk *= np.exp(-0.1 * np.arange(ds)).astype(np.float32)
    got = port_sketch.cluster_bisect_order(sk)
    np.testing.assert_array_equal(got, ref_sketch.cluster_bisect_order(sk))
    assert sorted(got.tolist()) == list(range(n))


def _pair(docs, ids, dtype="bfloat16"):
    ref_ix = RefIndex.build(docs, ids, dtype=dtype)
    ref_ix.to_device(_mesh(), pad_multiple=256, tile_n=256, tile_b=64)
    port_ix = PortIndex.build(docs, ids, dtype=dtype).to_device("cpu", pad_multiple=256, tile_n=256)
    return ref_ix, port_ix


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_reorder_rows_matches_jax(dtype):
    rng = np.random.default_rng(5)
    docs, _ = _clustered_rows(rng, 3000, 48)
    ids = [f"d{i}" for i in range(len(docs))]
    qs = _normalize(rng.standard_normal((12, 48)).astype(np.float32))
    ref_ix, port_ix = _pair(docs, ids, dtype)
    v0, d0 = port_ix.search(qs, 20)
    old_rows = np.asarray(port_ix.store.vectors).copy()
    old_dev = port_ix._docs_dev[0][: len(docs)].clone()
    old_scales = None if port_ix.store.scales is None else port_ix.store.scales.copy()
    epoch = port_ix.mutation_epoch
    want = ref_ix.reorder_rows(sketch_dim=16, sample=2048)
    perm = port_ix.reorder_rows(sketch_dim=16, sample=2048)
    np.testing.assert_array_equal(perm, want)
    assert not np.array_equal(perm, np.arange(len(docs)))
    assert port_ix.mutation_epoch == epoch + 1
    # the rows (int8: the same bytes back from the dequantized rows), the
    # docids and the search results follow perm
    np.testing.assert_array_equal(np.asarray(port_ix.store.vectors), old_rows[perm])
    if old_scales is not None:
        np.testing.assert_array_equal(port_ix.store.scales, old_scales[perm])
    assert list(port_ix.store.docids) == [ids[i] for i in perm]
    v1, d1 = port_ix.search(qs, 20)
    np.testing.assert_array_equal(d1, d0)
    np.testing.assert_allclose(v1, v0, rtol=0, atol=1e-6)
    assert torch.equal(port_ix._docs_dev[0][: len(docs)], old_dev[torch.from_numpy(perm)])


def test_reorder_rows_reprojects_an_armed_sketch_and_raises_the_certified_share():
    rng = np.random.default_rng(6)
    docs, centers = _clustered_rows(rng, 4096, 32)
    ids = [f"d{i}" for i in range(len(docs))]
    qs = _normalize(centers[rng.integers(0, 16, 32)] + 0.35 / np.sqrt(32)
                    * rng.standard_normal((32, 32)).astype(np.float32))
    ix = PortIndex.build(docs, ids).to_device("cpu", pad_multiple=256)
    ix.enable_sketch(sketch_dim=16, cache=False)
    ev, ed = ix.search(qs, 10)
    ix.search(qs, 10, approx="adaptive", probe_bins=8)
    before = ix.last_adaptive_stats["certified_frac"]
    ix.reorder_rows()
    sk, tails = port_sketch.sketch_rows(ix._docs_dev[0], ix._sketch[2])
    assert torch.equal(ix._sketch[0][0], sk) and torch.equal(ix._sketch[1][0], tails)
    av, ad = ix.search(qs, 10, approx="adaptive", probe_bins=8)
    assert ix.last_adaptive_stats["certified_frac"] > before
    np.testing.assert_array_equal(ad, ed)
    np.testing.assert_allclose(av, ev, rtol=0, atol=1e-6)


def test_adaptive_search_matches_jax_and_exact():
    rng = np.random.default_rng(7)
    docs, centers = _clustered_rows(rng, 6000, 48)
    ids = [f"d{i}" for i in range(len(docs))]
    qs = _normalize(centers[rng.integers(0, 16, 16)] + 0.35 / np.sqrt(48)
                    * rng.standard_normal((16, 48)).astype(np.float32))
    ref_ix, port_ix = _pair(docs, ids)
    ref_ix.reorder_rows(sketch_dim=16, sample=4096)
    port_ix.reorder_rows(sketch_dim=16, sample=4096)
    rv, rd = ref_ix.search(qs, 32, approx="adaptive", probe_bins=8)
    pv, pd = port_ix.search(qs, 32, approx="adaptive", probe_bins=8)
    np.testing.assert_array_equal(pd, rd)
    np.testing.assert_allclose(pv, rv, rtol=0, atol=TOL)
    assert port_ix.last_adaptive_stats == ref_ix.last_adaptive_stats
    assert port_ix.last_certified.all()
    ev, ed = port_ix.search(qs, 32)
    np.testing.assert_array_equal(pd, ed)
    np.testing.assert_array_equal(pv, ev)


def test_int8_adaptive_runs_exact_search_with_all_certified():
    rng = np.random.default_rng(8)
    docs, _ = _clustered_rows(rng, 3000, 64)
    ix = PortIndex.build(docs, [f"d{i}" for i in range(3000)], dtype="int8").to_device("cpu", pad_multiple=256)
    qs = _normalize(rng.standard_normal((8, 64)).astype(np.float32))
    ev, ed = ix.search(qs, 16)
    av, ad = ix.search(qs, 16, approx="adaptive")
    np.testing.assert_array_equal(ad, ed)
    np.testing.assert_array_equal(av, ev)
    assert ix.last_adaptive_stats is None and ix.last_certified.all()
    assert ix.calibrate_adaptive(qs, 16) is None


def test_calibrate_adaptive_remembers_the_probe():
    rng = np.random.default_rng(9)
    docs, centers = _clustered_rows(rng, 6000, 48)
    qs = _normalize(centers[rng.integers(0, 16, 16)] + 0.35 / np.sqrt(48)
                    * rng.standard_normal((16, 48)).astype(np.float32))
    ix = PortIndex.build(docs, [f"d{i}" for i in range(6000)]).to_device("cpu", pad_multiple=256)
    ix.reorder_rows(sketch_dim=16, sample=4096)
    cal = ix.calibrate_adaptive(qs, 32, iters=1)
    assert cal["probe_bins"] >= 4 and cal["speedup"] > 0 and 0.0 <= cal["certified_frac"] <= 1.0
    assert ix._adaptive_cal["probe_by_k"][32] == cal["probe_bins"]
    ev, ed = ix.search(qs, 32)
    av, ad = ix.search(qs, 32, approx="adaptive")
    np.testing.assert_array_equal(ad, ed)
    assert ix.last_adaptive_stats["probe_bins"] == cal["probe_bins"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_calibration_npz_opens_in_the_other_package(tmp_path, writer):
    """sketch.npz with the adaptive points, written with no sketch armed by
    one package, loads in the other; the reader's enable_sketch keeps the
    points through its rewrite."""
    rng = np.random.default_rng(10)
    docs = _normalize(rng.standard_normal((4096, 48)).astype(np.float32))
    PortIndex.build(docs, [f"d{i}" for i in range(4096)]).save(tmp_path / "idx")
    qs = rng.standard_normal((8, 48)).astype(np.float32)
    if writer == "jax":
        w = RefIndex.load(tmp_path / "idx")
        w.to_device(_mesh(), pad_multiple=256, tile_n=256, tile_b=64)
    else:
        w = PortIndex.load(tmp_path / "idx").to_device("cpu", pad_multiple=256)
    cal = w.calibrate_adaptive(qs, 16, iters=1)
    if writer == "jax":
        r = PortIndex.load(tmp_path / "idx").to_device("cpu", pad_multiple=256)
    else:
        r = RefIndex.load(tmp_path / "idx")
        r.to_device(_mesh(), pad_multiple=256, tile_n=256, tile_b=64)
    assert r.load_adaptive_calibration()
    assert r._adaptive_cal["probe_by_k"][16] == cal["probe_bins"]
    assert r._adaptive_cal["speedup_by_k"][16] == pytest.approx(cal["speedup"], rel=1e-6)
    r.enable_sketch(sketch_dim=16)
    assert r._adaptive_cal["probe_by_k"][16] == cal["probe_bins"]
    again = (PortIndex.load(tmp_path / "idx").to_device("cpu", pad_multiple=256) if writer == "port"
             else None)
    if again is not None:
        assert again.load_adaptive_calibration() and again._adaptive_cal["probe_by_k"][16] == cal["probe_bins"]


def test_guaranteed_routes_through_adaptive():
    """The port's case of the JAX suite's test of the same name: at an
    injected speedup of 2.0 guaranteed mode runs the adaptive tier, at 0.9
    the sketch or exact route; exact results either way."""
    rng = np.random.default_rng(11)
    docs = _normalize(rng.standard_normal((6000, 48)).astype(np.float32))
    qs = _normalize(rng.standard_normal((12, 48)).astype(np.float32))
    ix = PortIndex.build(docs, [f"d{i}" for i in range(6000)]).to_device("cpu", pad_multiple=256)
    ev, ed = ix.search(qs, 32)
    ix._adaptive_cal["speedup_by_k"][32] = 2.0
    ix._adaptive_cal["probe_by_k"][32] = 16
    assert port_flat.ADAPTIVE_ROUTE_MARGIN == 1.05
    gv, gd = ix.search(qs, 32, approx="guaranteed")
    np.testing.assert_array_equal(gd, ed)
    np.testing.assert_allclose(gv, ev, rtol=0, atol=1e-6)
    assert ix.last_guaranteed_route == "adaptive" and ix.last_certified.all()
    assert ix.last_adaptive_stats["probe_bins"] == 16
    ix._adaptive_cal["speedup_by_k"][32] = 0.9
    gv2, gd2 = ix.search(qs, 32, approx="guaranteed")
    np.testing.assert_array_equal(gd2, ed)
    assert ix.last_guaranteed_route in ("sketch", "exact") and ix.last_certified.all()


def _write_tsv(path, rows):
    path.write_text("".join(f"{a}\t{b}\n" for a, b in rows))


def test_cli_adaptive_runs_are_byte_identical_to_exact(tmp_path, capsys):
    from codemix_dense_retrieval_torch.cli import main

    rng = np.random.default_rng(12)
    # rows with two nonzero coordinates: their f32 scores do not depend on
    # the summation order, so every path prints the same 6th decimal
    n, d = 2048, 32
    docs = np.zeros((n, d), np.float32)
    cols = rng.integers(0, d, (n, 2))
    docs[np.arange(n), cols[:, 0]] = rng.uniform(0.2, 1.0, n)
    docs[np.arange(n), cols[:, 1]] += rng.uniform(0.2, 1.0, n)
    PortIndex.build(_normalize(docs), [f"d{i}" for i in range(n)]).save(tmp_path / "ix")
    _write_tsv(tmp_path / "a.tsv", [(f"q{i}", f"query {i} alpha") for i in range(10)])
    _write_tsv(tmp_path / "b.tsv", [(f"q{i}", f"frage {i} beta") for i in range(10)])
    base = ["run-mix", "--device", "cpu", "--smoke_dim", str(d), "--index", str(tmp_path / "ix"),
            "--query_tsv", f"en={tmp_path / 'a.tsv'}", f"de={tmp_path / 'b.tsv'}", "--k", "20",
            "--cm_alphas", "0", "0.5", "1"]
    main([*base, "--outdir", str(tmp_path / "off")])
    main([*base, "--outdir", str(tmp_path / "ad"), "--approx", "adaptive"])
    for label in ("0", "0.5", "1"):
        name = f"cm-alpha-{label}.trec"
        assert (tmp_path / "ad" / name).read_bytes() == (tmp_path / "off" / name).read_bytes()
        meta = json.loads((tmp_path / "ad" / f"cm-alpha-{label}_meta.json").read_text())
        assert meta["approx"] == "adaptive" and meta["certified_frac"] == 1.0
    with pytest.raises(SystemExit, match="--fused does not support --approx adaptive: the probed-exact"):
        main([*base, "--outdir", str(tmp_path / "f"), "--fused", "--approx", "adaptive"])


@pytest.fixture(scope="module")
def corpus_stores(tmp_path_factory):
    """Two languages of a small corpus with token stores, written by
    encode-corpus in smoke mode."""
    from codemix_dense_retrieval_torch.cli import main

    root = tmp_path_factory.mktemp("adaptive_cli")
    rng = np.random.default_rng(13)
    for lang in ("xx", "yy"):
        (root / f"{lang}.tsv").write_text("".join(
            f"c{i}\t{lang} {' '.join(f'w{x}' for x in rng.integers(0, 200, rng.integers(2, 25)))}\n"
            for i in range(300)))
    main(["encode-corpus", "--device", "cpu", "--smoke_dim", "32", "--corpus_tsv", f"xx={root / 'xx.tsv'}",
          f"yy={root / 'yy.tsv'}", "--out", str(root / "ix"), "--tokens_per_doc", "8", "--storage_dtype",
          "float32"])
    _write_tsv(root / "a.tsv", [(f"q{i}", f"w{i} w{2 * i} w{i + 7}") for i in range(9)])
    _write_tsv(root / "b.tsv", [(f"q{i}", f"w{3 * i} w{i + 1}") for i in range(9)])
    return root


@pytest.mark.parametrize("command", ["run-mono", "run-mix", "run-bilingual", "run-bilingual-mix", "run-rerank"])
def test_cli_commands_take_approx_adaptive(corpus_stores, command, tmp_path):
    """Each runner passes --approx adaptive to the index (run-rerank to its
    dense stage): the run files equal --approx off's byte for byte."""
    from codemix_dense_retrieval_torch.cli import main

    root = corpus_stores
    ix = [str(root / "ix" / "xx")] + ([str(root / "ix" / "yy")] if "bilingual" in command else [])
    args = {
        "run-mono": ["--queries", str(root / "a.tsv"), "--k", "20"],
        "run-mix": ["--query_tsv", f"en={root / 'a.tsv'}", f"de={root / 'b.tsv'}", "--k", "20",
                    "--cm_alphas", "0.5"],
        "run-bilingual": ["--queries", str(root / "a.tsv"), "--k", "20"],
        "run-bilingual-mix": ["--query_tsv", f"en={root / 'a.tsv'}", f"de={root / 'b.tsv'}", "--k", "20",
                              "--cm_alphas", "0.5"],
        "run-rerank": ["--queries", str(root / "a.tsv"), "--k", "10", "--k_dense", "40"],
    }[command]
    base = [command, "--device", "cpu", "--smoke_dim", "32", "--index", *ix, *args]
    main([*base, "--outdir", str(tmp_path / "off")])
    main([*base, "--outdir", str(tmp_path / "ad"), "--approx", "adaptive"])
    runs = sorted(p.name for p in (tmp_path / "off").glob("*.trec"))
    assert runs and runs == sorted(p.name for p in (tmp_path / "ad").glob("*.trec"))
    for name in runs:
        assert (tmp_path / "ad" / name).read_bytes() == (tmp_path / "off" / name).read_bytes(), name


def test_two_stage_searcher_refuses_a_reordered_index(corpus_stores):
    """reorder_rows bumps mutation_epoch: a two-stage searcher built before
    it refuses to score token blocks by stale row ids, and one built after
    it refuses the reordered index, as the JAX package does."""
    from codemix_dense_retrieval_torch.io.token_shards import TokenShardStore
    from codemix_dense_retrieval_torch.pipeline.rerank import TwoStageSearcher

    ix = PortIndex.load(corpus_stores / "ix" / "xx").to_device("cpu")
    tokens = TokenShardStore.open(corpus_stores / "ix" / "xx" / "tokens")
    searcher = TwoStageSearcher(ix, tokens)
    q = np.zeros((1, 32), np.float32)
    q[0, 0] = 1.0
    qt = np.zeros((1, 4, 32), np.float32)
    searcher.search(q, qt, np.array([1]), 5, k_dense=10)
    ix.reorder_rows(sketch_dim=8)
    with pytest.raises(ValueError, match="mutated since this TwoStageSearcher was built"):
        searcher.search(q, qt, np.array([1]), 5, k_dense=10)
    with pytest.raises(ValueError, match="dense index was mutated"):
        TwoStageSearcher(ix, tokens)
