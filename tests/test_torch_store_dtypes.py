"""float32 and float16 stores and token stores: every search path of the
port over them against the JAX package on the same seeded numpy inputs
(Pallas kernels in interpret mode). On the CPU the port's wrappers run
their plain versions; these tests hold the arithmetic and the routing the
card's f16 and f32 kernel instances sit behind.

Tolerances: ids equal; scores and bin maxima 1e-5 abs (the two packages
sum the same f32 products in another order; unit rows); MaxSim 1e-5 abs
(sums of 8 maxima of such products).
"""

import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex as PortIndex
from codemix_dense_retrieval_torch.io.token_shards import TokenShardWriter as PortWriter
from codemix_dense_retrieval_torch.io.token_shards import TokenShardStore as PortTokens
from codemix_dense_retrieval_torch.ops import maxsim as port_maxsim
from codemix_dense_retrieval_torch.ops import sketch as port_sketch
from codemix_dense_retrieval_torch.ops import topk as port_topk
from codemix_dense_retrieval_torch.pipeline import rerank as port_rerank
from codemix_dense_retrieval_tpu.index.flat import DenseFlatIndex as RefIndex
from codemix_dense_retrieval_tpu.io.token_shards import TokenShardStore as RefTokens
from codemix_dense_retrieval_tpu.ops import maxsim as ref_maxsim
from codemix_dense_retrieval_tpu.ops import sketch as ref_sketch
from codemix_dense_retrieval_tpu.ops import topk as ref_topk
from codemix_dense_retrieval_tpu.parallel.mesh import make_mesh
from codemix_dense_retrieval_tpu.pipeline import rerank as ref_rerank

REPO = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-5
DTYPES = ["float32", "float16"]
NEG_INF = port_topk.NEG_INF


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _cast(x, dtype):
    """(torch tensor, jnp array) of x rounded to ``dtype``, the same values."""
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t, jnp.asarray(t.to(torch.float32).numpy(), getattr(jnp, dtype))


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("dtype", DTYPES)
def test_index_search_over_float_stores_matches_jax(dtype, k):
    """The transposed route (kernel 2 on the card): 20,000 rows, between
    the full-sort and two-level thresholds; f32 queries cast to the index
    dtype by both packages."""
    rng = np.random.default_rng(7 + k)
    docs, qs = _unit(rng, 20_000, 32), rng.standard_normal((12, 32)).astype(np.float32)
    ids = [f"d{i}" for i in range(len(docs))]
    ref = RefIndex.build(docs, ids, dtype=dtype).to_device(make_mesh(shard=1, tp=1))
    port = PortIndex.build(docs, ids, dtype=dtype).to_device("cpu")
    assert port._docs_dev[0].dtype == getattr(torch, dtype)
    rv, rd = ref.search(qs, k)
    gv, gd = port.search(qs, k)
    np.testing.assert_array_equal(gd, rd)
    np.testing.assert_allclose(gv, rv, atol=ATOL, rtol=0)


@pytest.mark.parametrize("layout", ["bin_major", "transposed"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bin_scores_over_float_operands_match_pallas(dtype, layout):
    """Kernel A's (bin-major, the two-level route's phase 1) and kernel 2's
    oracle over f32 and f16 operands against the JAX Pallas kernels."""
    rng = np.random.default_rng(11)
    b, n, d, n_valid, g = 8, 2048, 64, 2000 - 13, 8
    q, jq = _cast(_unit(rng, b, d), dtype)
    x, jx = _cast(_unit(rng, n, d), dtype)
    if layout == "bin_major":
        rs, rb = ref_topk._bin_scores_pallas_bm(jq, jx, g, n_valid, tile_b=8, tile_n=1024, interpret=True)
    else:
        rs, rb = ref_topk._bin_scores_pallas(jq, jx, g, n_valid, tile_b=8, tile_n=1024, interpret=True)
    gs, gb = port_topk.bin_scores(q, x, n_valid, g, layout=layout)
    rs, rb = np.asarray(rs), np.asarray(rb)
    if layout == "bin_major":
        rb = rb.T if rb.shape != gb.shape else rb
    else:
        rs = rs.T if rs.shape != gs.shape else rs
        rb = rb.T if rb.shape != gb.shape else rb
    assert gs.shape == rs.shape and gb.shape == rb.shape
    live = rs > NEG_INF / 2
    np.testing.assert_allclose(gs.numpy()[live], rs[live], atol=ATOL, rtol=0)
    assert (gs.numpy()[~live] == NEG_INF).all()
    np.testing.assert_allclose(gb.numpy(), rb, atol=ATOL, rtol=0)


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [8, 16])
@pytest.mark.parametrize("b,n,n_valid", [(1, 272, 251), (65, 400, 100)])
def test_transposed_f32_bin_scores_match_pallas_at_kernel_tile_edges(b, n, n_valid, g, score_dtype):
    """Kernel 2's f32 oracle at the card kernel's edges: one query and 65
    (past the n64 tile), N = 128 k + 16 (a ragged last row tile), n_valid
    inside a bin and far below N, G = 8 and 16, f32 and bf16 scores;
    against the JAX Pallas kernel in interpret mode (one tile). Tolerance:
    f32 scores and bin maxima ATOL; bf16 scores one bf16 ulp (2^-8 of the
    magnitude) plus ATOL, since the f32 sums, which differ in order, may
    round to neighbouring bf16 values."""
    rng = np.random.default_rng(15 + b + g)
    q, jq = _cast(_unit(rng, b, 64), "float32")
    x, jx = _cast(_unit(rng, n, 64), "float32")
    rs, rb = ref_topk._bin_scores_pallas(jq, jx, g, n_valid, tile_b=b, tile_n=n, interpret=True,
                                         score_dtype=getattr(jnp, score_dtype))
    gs, gb = port_topk.bin_scores(q, x, n_valid, g, layout="transposed",
                                  score_dtype=getattr(torch, score_dtype))
    rs, rb = np.asarray(rs.astype(jnp.float32)), np.asarray(rb)
    gs, gb = gs.to(torch.float32).numpy(), gb.numpy()
    assert gs.shape == rs.shape == (n, b) and gb.shape == rb.shape == (n // g, b)
    lim = ATOL if score_dtype == "float32" else np.abs(rs[:n_valid]) * 2.0 ** -8 + ATOL
    assert (np.abs(gs[:n_valid] - rs[:n_valid]) <= lim).all()
    assert (gs[n_valid:] == rs[n_valid:]).all() and (rs[n_valid:] == np.float32(NEG_INF).astype(
        getattr(jnp, score_dtype)).astype(np.float32)).all()
    np.testing.assert_allclose(gb, rb, atol=ATOL, rtol=0)
    assert (gb[-(-n_valid // g):] == NEG_INF).all()


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("dtype", DTYPES)
def test_two_level_route_over_float_operands_gives_the_jax_ids(dtype, k):
    """The bin-major two-level cover (the route of shards >= 262,144 rows,
    called directly at a CPU test's size) over f32 and f16 rows."""
    rng = np.random.default_rng(20 + k)
    q, jq = _cast(_unit(rng, 6, 32), dtype)
    x, jx = _cast(_unit(rng, 8192, 32), dtype)
    rv, ri = ref_topk.topk_ip_bins_two_level(jq, jx, k, n_valid=8000, bin_size=8, super_size=8,
                                             tile_n=1024, interpret=True)
    gv, gi = port_topk.topk_ip_bins_two_level(q, x, k, n_valid=8000, bin_size=8, super_size=8,
                                              tile_n=1024)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["bins_rescore", "rescore_two_level"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rescore_over_float_operands_matches_jax(dtype, name):
    """Kernel 5's route (bin maxima only, then the covered rows rescored)."""
    rng = np.random.default_rng(31)
    q, jq = _cast(_unit(rng, 8, 64), dtype)
    x, jx = _cast(_unit(rng, 3000, 64), dtype)
    got = port_topk.binmax_only(q, x, 2990, 8)
    want = np.asarray(ref_topk._binmax_only_pallas(jq, jnp.pad(jx, ((0, 72), (0, 0))), 8, 2990,
                                                   tile_b=8, tile_n=1024, interpret=True)).T
    np.testing.assert_allclose(got.numpy(), want[:, : got.shape[1]], atol=ATOL, rtol=0)
    kw = dict(bin_size=8) if name == "bins_rescore" else dict(bin_size=8, super_size=4)
    rv, ri = getattr(ref_topk, f"topk_ip_{name}")(jq, jx, 10, interpret=True, **kw)
    gv, gi = getattr(port_topk, f"topk_ip_{name}")(q, x, 10, **kw)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_valid", [2048, 1999])
def test_binub_over_an_f32_sketch_matches_pallas(n_valid):
    """Kernel 7's oracle over the f32 ("legacy") sketch tier: full f32
    products, the tail term, the mask."""
    rng = np.random.default_rng(41)
    d_sk = rng.standard_normal((2048, 32)).astype(np.float32) * 0.3
    q_sk = rng.standard_normal((8, 32)).astype(np.float32) * 0.3
    d_tail = np.abs(rng.standard_normal(2048)).astype(np.float32) * 0.1
    q_tail = np.abs(rng.standard_normal(8)).astype(np.float32) * 0.1
    want = np.asarray(ref_sketch._binub_pallas(
        jnp.asarray(q_sk), jnp.asarray(q_tail).reshape(-1, 1), jnp.asarray(d_sk),
        jnp.asarray(d_tail).reshape(-1, 1), 8, n_valid, tile_b=8, tile_n=1024, interpret=True,
    ))
    t = torch.from_numpy
    got = port_sketch.binub(t(q_sk), t(q_tail), t(d_sk), t(d_tail), 8, n_valid)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sketch_tier_over_float_stores_matches_jax(dtype):
    """The sketch tier over f32 and f16 indexes keeps its bf16 sketch; fast
    and guaranteed search give the JAX package's ids and certificates."""
    rng = np.random.default_rng(51)
    decay = np.exp(-0.08 * np.arange(64))
    docs = _unit(rng, 4096, 64) * decay
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    qs = _unit(rng, 10, 64) * decay
    ids = [f"d{i}" for i in range(len(docs))]
    ref = RefIndex.build(docs, ids, dtype=dtype).to_device(make_mesh(shard=1, tp=1))
    port = PortIndex.build(docs, ids, dtype=dtype).to_device("cpu")
    ref.enable_sketch(sketch_dim=16, cache=False)
    port.enable_sketch(sketch_dim=16, cache=False)
    assert port._sketch[0][0].dtype == torch.bfloat16
    for mode in (True, "guaranteed"):
        rv, rd = ref.search(qs, 10, approx=mode)
        gv, gd = port.search(qs, 10, approx=mode)
        np.testing.assert_array_equal(gd, rd)
        np.testing.assert_allclose(gv, rv, atol=ATOL, rtol=0)
    ev, ed = port.search(qs, 10)
    np.testing.assert_array_equal(port.search(qs, 10, approx="guaranteed")[1], ed)


@pytest.mark.parametrize("dtype", DTYPES)
def test_reorder_and_adaptive_search_over_float_stores_match_jax(dtype):
    """reorder_rows and the adaptive tier over f32 and f16 indexes: the JAX
    package's permutation, ids and certificate stats; the exact search's
    ids and values."""
    rng = np.random.default_rng(91)
    d = 48
    centers = _unit(rng, 16, d)
    docs = centers[rng.integers(0, 16, 6000)] + 0.35 / np.sqrt(d) * rng.standard_normal((6000, d))
    docs = (docs / np.linalg.norm(docs, axis=1, keepdims=True)).astype(np.float32)
    qs = centers[rng.integers(0, 16, 16)] + 0.35 / np.sqrt(d) * rng.standard_normal((16, d))
    qs = (qs / np.linalg.norm(qs, axis=1, keepdims=True)).astype(np.float32)
    ids = [f"d{i}" for i in range(len(docs))]
    ref = RefIndex.build(docs, ids, dtype=dtype)
    ref.to_device(make_mesh(shard=1, tp=1), pad_multiple=256, tile_n=256, tile_b=64)
    port = PortIndex.build(docs, ids, dtype=dtype).to_device("cpu", pad_multiple=256, tile_n=256)
    np.testing.assert_array_equal(port.reorder_rows(sketch_dim=16, sample=4096),
                                  ref.reorder_rows(sketch_dim=16, sample=4096))
    assert port._docs_dev[0].dtype == getattr(torch, dtype)
    rv, rd = ref.search(qs, 32, approx="adaptive", probe_bins=64)
    gv, gd = port.search(qs, 32, approx="adaptive", probe_bins=64)
    np.testing.assert_array_equal(gd, rd)
    np.testing.assert_allclose(gv, rv, atol=ATOL, rtol=0)
    assert port.last_adaptive_stats == ref.last_adaptive_stats
    assert port.last_adaptive_stats["certified_frac"] > 0
    ev, ed = port.search(qs, 32)
    np.testing.assert_array_equal(gd, ed)
    np.testing.assert_array_equal(gv, ev)


@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_maxsim_over_float_doc_tokens_matches_jax(dtype):
    """Kernel 6's oracle over f16 and f32 doc tokens (the JAX package casts
    any doc-token dtype to f32)."""
    rng = np.random.default_rng(61)
    b, tq, k, td, d = 3, 8, 5, 16, 32
    qt = rng.standard_normal((b, tq, d)).astype(np.float32)
    dt = rng.standard_normal((b, k, td, d)).astype(np.float32)
    qm = (rng.random((b, tq)) < 0.8).astype(np.int32)
    dm = (rng.random((b, k, td)) < 0.8).astype(np.int32)
    dm[0, 1] = 0
    d_t, d_j = _cast(dt.reshape(-1, d), dtype)
    d_t, d_j = d_t.reshape(dt.shape), d_j.reshape(dt.shape)
    want = np.asarray(ref_maxsim.maxsim_scores_pallas(jnp.asarray(qt), jnp.asarray(qm), d_j,
                                                      jnp.asarray(dm), interpret=True))
    got = port_maxsim.maxsim_scores(torch.from_numpy(qt), torch.from_numpy(qm), d_t, torch.from_numpy(dm))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert got[0, 1] == 0.0


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_two_stage_over_float_token_stores_matches_jax(tmp_path, dtype):
    """The two-stage searcher over an f32 (and f16) index and token store,
    card-resident blocks and memmap gathers, against the JAX searcher."""
    rng = np.random.default_rng(71)
    n, td, d, nq, tq = 64, 8, 32, 6, 4
    toks = rng.standard_normal((n, td, d)).astype(np.float32)
    toks /= np.linalg.norm(toks, axis=-1, keepdims=True)
    lens = rng.integers(1, td + 1, size=n)
    toks *= (np.arange(td)[None] < lens[:, None])[..., None]
    dense = toks.sum(axis=1)
    dense /= np.linalg.norm(dense, axis=-1, keepdims=True)
    q_toks = rng.standard_normal((nq, tq, d)).astype(np.float32)
    q_toks /= np.linalg.norm(q_toks, axis=-1, keepdims=True)
    q_lens = np.array([tq, tq, 2, 3, 1, tq])
    q_dense = q_toks.sum(axis=1)
    q_dense /= np.linalg.norm(q_dense, axis=-1, keepdims=True)
    ids = [f"d{i}" for i in range(n)]
    w = PortWriter(tmp_path / "tok", token_dim=d, tokens_per_doc=td, dtype=dtype, rows_per_file=24)
    w.append(toks, lens, ids)
    w.finalize()
    ref_ix = RefIndex.build(dense, ids, dtype=dtype).to_device(make_mesh(shard=1, tp=1), pad_multiple=64)
    port_ix = PortIndex.build(dense, ids, dtype=dtype).to_device("cpu", pad_multiple=64)
    rs, ri = ref_rerank.TwoStageSearcher(ref_ix, RefTokens.open(tmp_path / "tok")).search(
        q_dense, q_toks, q_lens, 5, k_dense=16, return_docids=False)
    store = PortTokens.open(tmp_path / "tok")
    for resident in (True, False):
        s = port_rerank.TwoStageSearcher(port_ix, store, device_resident=resident)
        gs, gi = s.search(q_dense, q_toks, q_lens, 5, k_dense=16, return_docids=False)
        np.testing.assert_array_equal(gi, np.asarray(ri))
        np.testing.assert_allclose(gs, np.asarray(rs), rtol=0, atol=ATOL)
        if resident:
            assert s._tok_dev.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_cli_encode_corpus_then_run_mix_over_float_stores(tmp_path, dtype):
    """encode-corpus --storage_dtype float32|float16 (with a token store of
    that dtype), then run-mix over the store, exact and guaranteed."""
    rng = np.random.default_rng(81)
    words = [f"w{i}" for i in range(40)]
    (tmp_path / "c.tsv").write_text("".join(
        f"d{i}\t{' '.join(rng.choice(words, size=6))}\n" for i in range(60)))
    enc = subprocess.run(
        [sys.executable, "-m", "codemix_dense_retrieval_torch", "encode-corpus", "--device", "cpu",
         "--corpus_tsv", f"xx={tmp_path / 'c.tsv'}", "--storage_dtype", dtype, "--token_dtype", dtype,
         "--tokens_per_doc", "4", "--smoke_dim", "32", "--out", str(tmp_path / "ix"),
         "--batch", "16", "--enc_batch", "8"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert enc.returncode == 0, enc.stderr
    store_dir = pathlib.Path(json.loads(enc.stdout)["xx"])
    store = PortIndex.load(store_dir).store
    assert store.count == 60 and store.manifest.dtype == dtype
    assert PortTokens.open(store_dir / "tokens").dtype == dtype
    for lang, text in (("en", "w1 w2 w3"), ("zh", "w3 w9")):
        (tmp_path / f"{lang}.tsv").write_text("".join(f"q{i}\t{text} w{i}\n" for i in range(5)))
    runs = {}
    for approx in ("off", "guaranteed"):
        run = subprocess.run(
            [sys.executable, "-m", "codemix_dense_retrieval_torch", "run-mix", "--device", "cpu",
             "--index", str(store_dir), "--smoke_dim", "32", "--k", "7", "--cm_alphas", "0.5",
             "--query_tsv", f"en={tmp_path / 'en.tsv'}", f"zh={tmp_path / 'zh.tsv'}",
             "--approx", approx, "--outdir", str(tmp_path / approx)],
            cwd=REPO, capture_output=True, text=True, timeout=300,
        )
        assert run.returncode == 0, run.stderr
        runs[approx] = (tmp_path / approx / "cm-alpha-0.5.trec").read_text()
    lines = runs["off"].splitlines()
    assert len(lines) == 5 * 7 and all(line.split("\t")[2].endswith("#xx") for line in lines)
    assert runs["guaranteed"] == runs["off"]


def _rna_model(x):
    """tf32 rounding (10 fraction bits, to nearest, ties away from zero) as
    the choice between x's two tf32 neighbours, nearer first, in float64."""
    bits = x.astype(np.float32).view(np.uint32)
    down = (bits & np.uint32(0xFFFFE000)).view(np.float32).astype(np.float64)
    up = ((bits & np.uint32(0xFFFFE000)) + np.uint32(0x2000)).view(np.float32).astype(np.float64)
    xd = x.astype(np.float64)
    return np.where(np.abs(xd - down) < np.abs(up - xd), down, up).astype(np.float32)


@pytest.mark.parametrize("kind", ["unit_rows", "ties", "small_and_zero"])
def test_tf32_split_plain_matches_a_numpy_model(kind):
    """The bin-major f32 kernels take their queries split once per call
    (``topk.tf32_split``: hi = tf32(x), lo = tf32(x - hi)); its plain
    version against a numpy model of ``cvt.rna.tf32.f32``, and the split's
    reach: hi + lo within 2^-22 of |x|."""
    rng = np.random.default_rng(14)
    if kind == "unit_rows":
        x = rng.standard_normal((5, 96)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    elif kind == "ties":  # low 13 bits exactly half a tf32 ulp, both signs
        b = (rng.integers(0x3C000000, 0x41000000, 256, dtype=np.uint32) & np.uint32(0xFFFFE000)) | np.uint32(0x1000)
        x = b.view(np.float32) * np.where(np.arange(256) % 2, -1, 1).astype(np.float32)
    else:
        x = np.concatenate([rng.standard_normal(60).astype(np.float32) * np.float32(1e-30),
                            np.zeros(4, np.float32)])
    got = port_topk.tf32_split(torch.from_numpy(x)).numpy()
    hi = _rna_model(x)
    lo = _rna_model((x.astype(np.float32) - hi).astype(np.float32))
    np.testing.assert_array_equal(got[0].view(np.uint32), hi.view(np.uint32))
    np.testing.assert_array_equal(got[1].view(np.uint32), lo.view(np.uint32))
    assert not (got.view(np.uint32) & 0x1FFF).any()
    err = np.abs(got[0].astype(np.float64) + got[1] - x.astype(np.float64))
    assert (err <= np.abs(x.astype(np.float64)) * 2.0 ** -22 + 1e-45).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_kernel_queries_split_f32_and_pass_half_types_as_they_are(dtype):
    """The query operand of the float bin kernels' C entries: the f32
    kernels (both layouts, and kernels 5 and 7) take the (2, B, d) tf32
    split, equal bit for bit to ``tf32_split_plain``; bf16 and f16 take the
    queries themselves."""
    rng = np.random.default_rng(15)
    q = torch.from_numpy(_unit(rng, 7, 96)).to(getattr(torch, dtype))
    got = port_topk._kernel_queries(q)
    if dtype == "float32":
        assert got.shape == (2, 7, 96) and got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), port_topk.tf32_split_plain(q).view(torch.int32))
    else:
        assert got is q


@pytest.mark.parametrize("layout", ["bin_major", "transposed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bin_scores_hands_each_layout_its_query_operand(monkeypatch, layout, dtype):
    """The card route of ``topk.bin_scores`` (its kernel and the operand
    checks stubbed; tensors on the meta device) splits f32 queries for
    kernel 2 as for kernel A, and passes bf16 queries unsplit."""
    from codemix_dense_retrieval_torch.ops import kernels

    split_of = []

    def fake_split(x):
        split_of.append(x)
        return torch.empty((2, *x.shape), dtype=torch.float32, device=x.device)

    launched = []
    monkeypatch.setattr(port_topk, "tf32_split", fake_split)
    monkeypatch.setattr(port_topk, "_cuda_operands",
                        lambda name, q, d, *a: (q.shape[0], q.shape[1], d.shape[0]))
    monkeypatch.setattr(port_topk, "_bin_scores_lib", lambda dt: "bin_scores_launch")
    monkeypatch.setattr(kernels, "launch", lambda fn, device, *args: launched.append((fn, args)) or 0)
    monkeypatch.setattr(kernels, "LAUNCHES", {k: 0 for k in kernels.LAUNCHES})
    dt = getattr(torch, dtype)
    q = torch.empty((5, 64), dtype=dt, device="meta")
    docs = torch.empty((256, 64), dtype=dt, device="meta")
    s, bm = port_topk.bin_scores(q, docs, 250, 16, layout=layout)
    assert len(launched) == 1 and launched[0][1][-2] == int(layout == "bin_major")
    assert s.shape == ((5, 256) if layout == "bin_major" else (256, 5))
    assert bm.shape == ((5, 16) if layout == "bin_major" else (16, 5))
    assert [x is q for x in split_of] == ([True] if dtype == "float32" else [])
    assert kernels.LAUNCHES[f"bin_scores_{layout}{kernels.dtype_suffix(dt)}"] == 1
