"""ops/sketch.py, the sketch tier of parallel/sharded_search.py and
index/flat.py: the port against the JAX package on the same numpy inputs
(Pallas in interpret mode).

Tolerances: ``fit_sketch`` is the same numpy code, so it is equal bit for
bit. The f32 projection sums in another order than XLA's, so tails agree
within 2e-6 and the bf16 sketch within one bf16 ulp (a value can fall on
the other side of a rounding boundary). Where the two packages are compared
end to end, both get the same sketch sidecar, so ids and certificates are
compared exactly; kernel 7's plain version and the Pallas kernel sum the
ds-long products in another order, hence 1e-6.
"""

import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex as PortIndex
from codemix_dense_retrieval_torch.ops import sketch as port
from codemix_dense_retrieval_torch.ops import topk as port_topk
from codemix_dense_retrieval_torch.ops.quant import quantize_rows_np
from codemix_dense_retrieval_torch.parallel.sharded_search import sharded_topk_ip_sketch
from codemix_dense_retrieval_tpu.index.flat import DenseFlatIndex as RefIndex
from codemix_dense_retrieval_tpu.ops import sketch as ref
from codemix_dense_retrieval_tpu.ops import topk as ref_topk
from codemix_dense_retrieval_tpu.parallel.mesh import make_mesh


def _normalize(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _anisotropic(rng, n, d, decay=0.05):
    """Rows with an exponentially decaying spectrum (sentence-embedding-like)."""
    x = rng.standard_normal((n, d)).astype(np.float32) * np.exp(-decay * np.arange(d)).astype(np.float32)
    return _normalize(x)


def _bf16(x):
    """f32 numpy -> (bf16 torch tensor, the same values as f32 numpy)."""
    b = np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)
    return torch.from_numpy(b.view(np.int16).copy()).view(torch.bfloat16), b.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _ref_sidecar(docs_np, proj, dtype=jnp.bfloat16):
    """The JAX package's sketch and tails over rows of ``dtype``, and the
    same arrays as port tensors."""
    s, t = ref.sketch_rows(jnp.asarray(docs_np, dtype), jnp.asarray(proj))
    s_np, t_np = np.asarray(s, np.float32), np.asarray(t)
    return (s, t), (_bf16(s_np)[0], _t(t_np))


def test_fit_sketch_equals_jax():
    rng = np.random.default_rng(0)
    docs = _anisotropic(rng, 700, 48)
    for ds, sample in ((8, 131072), (16, 300)):
        np.testing.assert_array_equal(
            port.fit_sketch(docs, ds, sample=sample), ref.fit_sketch(docs, ds, sample=sample)
        )
    with pytest.raises(ValueError, match="sketch_dim"):
        port.fit_sketch(docs, 49)


@pytest.mark.parametrize("sketch_dtype", ["bfloat16", "float32"])
def test_sketch_rows_match_jax(sketch_dtype):
    rng = np.random.default_rng(1)
    docs = _anisotropic(rng, 1000, 64)
    proj = ref.fit_sketch(docs, 16)
    jdt, tdt = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}[sketch_dtype]
    rs, rt = ref.sketch_rows(jnp.asarray(docs), jnp.asarray(proj), jdt)
    ps, pt = port.sketch_rows(_t(docs), _t(proj), tdt)
    rs, ps_np = np.asarray(rs, np.float32), ps.float().numpy()
    # one bf16 ulp of the larger value (f32: the f32 sum order only)
    ulp = np.maximum(np.abs(rs), np.abs(ps_np)) * (2.0 ** -7 if tdt == torch.bfloat16 else 2e-6)
    assert (np.abs(ps_np - rs) <= ulp + 1e-7).all()
    # a tail is the root of ||x||^2 - 2 s.s32 + ||s32||^2, three f32 sums of
    # order 1 in another order: a 1e-7 change moves a 0.3 tail by ~1e-6, so
    # 2e-6 where the stored sketches agree; a row whose sketch rounded the
    # other way has its tail computed against that value (1e-5)
    same = (ps_np == rs).all(axis=1) if tdt == torch.bfloat16 else np.ones(len(rs), bool)
    assert same.mean() > 0.9
    np.testing.assert_allclose(pt.numpy()[same], np.asarray(rt)[same], rtol=0, atol=2e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(rt), rtol=0, atol=1e-5)
    qs, qt = port.sketch_queries(_t(docs[:5]), _t(proj))
    np.testing.assert_array_equal(qs.float().numpy(), port.sketch_rows(_t(docs[:5]), _t(proj))[0].float().numpy())


@pytest.mark.parametrize("bin_size", [8, 16])
@pytest.mark.parametrize("n_valid", [2048, 1999, 1500])
def test_binub_plain_matches_pallas_interpret(bin_size, n_valid):
    rng = np.random.default_rng(2)
    d_sk, d_sk_np = _bf16(rng.standard_normal((2048, 32)).astype(np.float32) * 0.3)
    q_sk, q_sk_np = _bf16(rng.standard_normal((8, 32)).astype(np.float32) * 0.3)
    d_tail = np.abs(rng.standard_normal(2048)).astype(np.float32) * 0.1
    q_tail = np.abs(rng.standard_normal(8)).astype(np.float32) * 0.1
    want = np.asarray(ref._binub_pallas(
        jnp.asarray(q_sk_np, jnp.bfloat16), jnp.asarray(q_tail).reshape(-1, 1),
        jnp.asarray(d_sk_np, jnp.bfloat16), jnp.asarray(d_tail).reshape(-1, 1),
        bin_size, n_valid, tile_b=8, tile_n=1024, interpret=True,
    ))
    got = port.binub_plain(q_sk, _t(q_tail), d_sk, _t(d_tail), bin_size, n_valid)
    assert got.shape == want.shape == (8, 2048 // bin_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the CPU wrapper is the plain version; pad bins are NEG_INF
    np.testing.assert_array_equal(port.binub(q_sk, _t(q_tail), d_sk, _t(d_tail), bin_size, n_valid).numpy(),
                                  got.numpy())
    first_pad = -(-n_valid // bin_size)
    assert (got[:, first_pad:] == port_topk.NEG_INF).all()


@pytest.mark.parametrize("bin_size", [8, 16])
@pytest.mark.parametrize("n_valid", [1024, 100])
def test_binub_plain_matches_pallas_at_kernel_tile_edges(bin_size, n_valid):
    """ds = 96 (half of the card kernel's 64-dim chunk) and 130 queries (one
    past its 128-wide query tile), n_valid ragged or inside the first
    128-row tile."""
    rng = np.random.default_rng(3)
    d_sk, d_sk_np = _bf16(rng.standard_normal((1024, 96)).astype(np.float32) * 0.1)
    q_sk, q_sk_np = _bf16(rng.standard_normal((130, 96)).astype(np.float32) * 0.1)
    d_tail = np.abs(rng.standard_normal(1024)).astype(np.float32) * 0.1
    q_tail = np.abs(rng.standard_normal(130)).astype(np.float32) * 0.1
    want = np.asarray(ref._binub_pallas(
        jnp.asarray(q_sk_np, jnp.bfloat16), jnp.asarray(q_tail).reshape(-1, 1),
        jnp.asarray(d_sk_np, jnp.bfloat16), jnp.asarray(d_tail).reshape(-1, 1),
        bin_size, n_valid, tile_n=512, interpret=True,
    ))
    got = port.binub(q_sk, _t(q_tail), d_sk, _t(d_tail), bin_size, n_valid)
    assert got.shape == want.shape == (130, 1024 // bin_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (got[:, -(-n_valid // bin_size):] == port_topk.NEG_INF).all()


@pytest.mark.parametrize("k_bins", [3, 7, 16])
def test_select_bins_two_level_unselected_bound_matches_jax(k_bins):
    rng = np.random.default_rng(3)
    bm = np.round(rng.standard_normal((6, 128)), 1).astype(np.float32)  # many ties
    ids_r, ub_r = ref_topk._select_bins_two_level(jnp.asarray(bm), k_bins, 8, return_unselected_bound=True)
    ids_p, ub_p = port_topk._select_bins_two_level(_t(bm), k_bins, 8, return_unselected_bound=True)
    np.testing.assert_array_equal(ids_p.numpy(), np.asarray(ids_r))
    np.testing.assert_array_equal(ub_p.numpy(), np.asarray(ub_r))
    np.testing.assert_array_equal(port_topk._select_bins_two_level(_t(bm), k_bins, 8).numpy(), ids_p.numpy())


def test_rescore_candidates_int8_matches_jax():
    rng = np.random.default_rng(4)
    dv, dsc = quantize_rows_np(_normalize(rng.standard_normal((512, 64)).astype(np.float32)))
    qv, qsc = quantize_rows_np(_normalize(rng.standard_normal((6, 64)).astype(np.float32)))
    bins = np.sort(rng.choice(64, size=(6, 10), replace=True), axis=1).astype(np.int32)
    rv, ri = ref_topk._rescore_candidates_int8(jnp.asarray(dv), jnp.asarray(dsc), jnp.asarray(qv),
                                               jnp.asarray(qsc), jnp.asarray(bins), 8, 500, 12)
    pv, pi = port_topk._rescore_candidates_int8(_t(dv), _t(dsc), _t(qv), _t(qsc), _t(bins).long(), 8, 500, 12)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))  # exact integer products, same rescale order


@pytest.mark.parametrize("docs_dtype", ["bfloat16", "float32"])
def test_topk_ip_sketch_ids_and_certificates_equal_jax(docs_dtype):
    rng = np.random.default_rng(5)
    docs = _anisotropic(rng, 3000, 64, decay=0.08)
    qs = _anisotropic(rng, 16, 64, decay=0.08)
    proj = ref.fit_sketch(docs, 24)
    jdt = jnp.bfloat16 if docs_dtype == "bfloat16" else jnp.float32
    (rs, rt), (ps, pt) = _ref_sidecar(docs, proj, jdt)
    docs_t = _bf16(docs)[0] if docs_dtype == "bfloat16" else _t(docs)
    for probe in (8, 24, 64):
        rv, ri, rc = ref.topk_ip_sketch(jnp.asarray(qs), jnp.asarray(docs, jdt), rs, rt, jnp.asarray(proj), 10,
                                        probe_bins=probe, tile_n=512)
        pv, pi, pc = port.topk_ip_sketch(_t(qs), docs_t, ps, pt, _t(proj), 10, probe_bins=probe, tile_n=512)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
        np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=0, atol=1e-6)
    assert pc.any(), "anisotropic data at probe 64 should certify some queries"


def test_topk_ip_sketch_int8_ids_and_certificates_equal_jax():
    rng = np.random.default_rng(6)
    docs = _anisotropic(rng, 2048, 64, decay=0.08)
    qs = _anisotropic(rng, 12, 64, decay=0.08)
    dv, dsc = quantize_rows_np(docs)
    deq = dv.astype(np.float32) * dsc[:, None]
    proj = ref.fit_sketch(deq, 16)
    rs, rt = ref.sketch_rows_int8(jnp.asarray(dv), jnp.asarray(dsc), jnp.asarray(proj))
    ps, pt = _bf16(np.asarray(rs, np.float32))[0], _t(np.asarray(rt))
    # the port's own int8 sidecar is the same within the projection's
    # round-off (tolerances of test_sketch_rows_match_jax)
    _, pt2 = port.sketch_rows_int8(_t(dv), _t(dsc), _t(proj))
    np.testing.assert_allclose(pt2.numpy(), np.asarray(rt), rtol=0, atol=1e-5)
    for probe in (16, 48):
        rv, ri, rc = ref.topk_ip_sketch_int8(jnp.asarray(qs), jnp.asarray(dv), jnp.asarray(dsc), rs, rt,
                                             jnp.asarray(proj), 10, probe_bins=probe, tile_n=512)
        pv, pi, pc = port.topk_ip_sketch_int8(_t(qs), _t(dv), _t(dsc), ps, pt, _t(proj), 10,
                                              probe_bins=probe, tile_n=512)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    assert pc.any()


def test_certificate_soundness_fuzz():
    """Many seeds x regimes: certified => exactly the oracle's ids (the port
    alone, against a stable f32 top-k of the values the kernels see)."""
    violations, total_cert = [], 0
    for seed in range(12):
        rng = np.random.default_rng(1000 + seed)
        decay = [0.0, 0.01, 0.05, 0.2][seed % 4]
        d = [64, 128][seed % 2]
        ds = [8, 16, d // 4][seed % 3]
        n = 2048 + 173 * seed  # ragged row counts
        k = [5, 17, 50][seed % 3]
        probe = [8, 24, 64][(seed // 2) % 3]
        if probe * 8 < k:
            probe = -(-k // 8) + 2
        docs = (_anisotropic(rng, n, d, decay=decay) if decay
                else _normalize(rng.standard_normal((n, d)).astype(np.float32)))
        queries = _normalize(docs[rng.choice(n, 16, replace=False)]
                             + 0.05 * rng.standard_normal((16, d)).astype(np.float32))
        if seed % 2:
            docs_t, docs_eff = _bf16(docs)
            q_eff = _bf16(queries)[1]
        else:
            docs_t, docs_eff, q_eff = _t(docs), docs, queries
        proj = port.fit_sketch(docs_eff, ds)
        s, t = port.sketch_rows(docs_t, _t(proj))
        _, idx, cert = port.topk_ip_sketch(_t(queries), docs_t, s, t, _t(proj), k, probe_bins=probe)
        oracle = port_topk._stable_topk(_t(q_eff) @ _t(docs_eff).T, k)[1].numpy()
        total_cert += int(cert.sum())
        for q in np.flatnonzero(cert.numpy()):
            if not np.array_equal(idx[q].numpy(), oracle[q]):
                violations.append((seed, int(q)))
    assert not violations, violations
    assert total_cert > 0


def test_full_width_sketch_certifies_every_query():
    """ds = d leaves no tail: every query certifies and the ids are exact."""
    rng = np.random.default_rng(7)
    docs = _normalize(rng.standard_normal((1024, 32)).astype(np.float32))
    qs = _normalize(rng.standard_normal((8, 32)).astype(np.float32))
    docs_t, docs_eff = _bf16(docs)
    proj = port.fit_sketch(docs_eff, 32)
    s, t = port.sketch_rows(docs_t, _t(proj))
    _, idx, cert = port.topk_ip_sketch(_t(qs), docs_t, s, t, _t(proj), 10, probe_bins=32)
    assert cert.all()
    oracle = port_topk._stable_topk(_t(_bf16(qs)[1]) @ _t(docs_eff).T, 10)[1]
    np.testing.assert_array_equal(idx.numpy(), oracle.numpy())


def test_too_few_probe_bins_raises():
    rng = np.random.default_rng(8)
    docs = _anisotropic(rng, 2048, 64)
    proj = port.fit_sketch(docs, 16)
    s, t = port.sketch_rows(_t(docs), _t(proj))
    with pytest.raises(ValueError, match="too few candidates"):
        port.topk_ip_sketch(_t(docs[:4]), _t(docs), s, t, _t(proj), 64, probe_bins=2)


def _indexes(docs, dtype="bfloat16", pad=256):
    ids = [f"d{i}" for i in range(len(docs))]
    ref_ix = RefIndex.build(docs, ids, dtype=dtype).to_device(make_mesh(shard=1, tp=1), pad_multiple=pad)
    port_ix = PortIndex.build(docs, ids, dtype=dtype).to_device("cpu", pad_multiple=pad)
    return ref_ix, port_ix


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_index_fast_and_guaranteed_match_jax(dtype):
    rng = np.random.default_rng(9)
    docs = _anisotropic(rng, 4096, 64, decay=0.05)
    qs = _anisotropic(rng, 21, 64, decay=0.05)
    ref_ix, port_ix = _indexes(docs, dtype)
    ref_ix.enable_sketch(sketch_dim=24, probe_bins=32, cache=False)
    port_ix.enable_sketch(sketch_dim=24, probe_bins=32, cache=False)
    np.testing.assert_array_equal(port_ix._sketch[2].numpy(), np.asarray(ref_ix._sketch[2]))
    # the same sidecar in both packages, so ids and certificates compare exactly
    sk = _bf16(np.asarray(ref_ix._sketch[0], np.float32))[0]
    port_ix._sketch = (sk, _t(np.asarray(ref_ix._sketch[1])), *port_ix._sketch[2:])
    rv, rd = ref_ix.search(qs, 10, approx=True, query_block=8)
    pv, pd = port_ix.search(qs, 10, approx=True, query_block=8)
    np.testing.assert_array_equal(pd, rd)
    np.testing.assert_array_equal(port_ix.last_certified, ref_ix.last_certified)
    assert port_ix.last_certified.any() and port_ix.last_guaranteed_route is None
    ev, ed = port_ix.search(qs, 10)
    assert port_ix.last_certified is None
    gv, gd = port_ix.search(qs, 10, approx="guaranteed")
    np.testing.assert_array_equal(gd, ed)
    np.testing.assert_allclose(gv, ev, rtol=0, atol=1e-5)
    assert port_ix.last_certified.all() and port_ix.last_guaranteed_route == "sketch"
    assert not port_ix.last_guaranteed_direct


def test_index_guaranteed_is_exact_on_isotropic_data():
    """Worst case with a thin probe: escalation makes every query exact."""
    rng = np.random.default_rng(10)
    docs = _normalize(rng.standard_normal((4096, 64)).astype(np.float32))
    qs = _normalize(rng.standard_normal((16, 64)).astype(np.float32))
    ix = PortIndex.build(docs, [f"d{i}" for i in range(4096)]).to_device("cpu", pad_multiple=256)
    ix.enable_sketch(sketch_dim=8, probe_bins=8, cache=False)
    ix.search(qs, 10, approx=True)
    assert not ix.last_certified.all()
    gv, gi = ix.search(qs, 10, return_docids=False, approx="guaranteed")
    ev, ei = ix.search(qs, 10, return_docids=False)
    np.testing.assert_array_equal(gi, ei)
    np.testing.assert_allclose(gv, ev, rtol=0, atol=1e-5)


@pytest.mark.parametrize("approx, err", [("adaptive", NotImplementedError), ("yes-please", ValueError)])
def test_index_refuses_the_adaptive_tier_and_bad_values(approx, err):
    """The adaptive tier refuses an int8 shard (the index runs exact search
    there instead), and the index refuses an unknown approx value."""
    from codemix_dense_retrieval_torch.parallel.sharded_search import sharded_topk_ip_adaptive

    rng = np.random.default_rng(11)
    docs = _anisotropic(rng, 1024, 32)
    if err is NotImplementedError:
        dv, _ = quantize_rows_np(docs)
        with pytest.raises(err, match="int8"):
            sharded_topk_ip_adaptive(_t(docs[:4]), _t(dv), torch.tensor([1024], dtype=torch.int32), 5)
        return
    ix = PortIndex.build(docs, [str(i) for i in range(1024)]).to_device("cpu", pad_multiple=256)
    with pytest.raises(err, match="guaranteed"):
        ix.search(docs[:4], 5, approx=approx)


def test_calibrate_sketch_matches_jax():
    rng = np.random.default_rng(20)
    docs = _anisotropic(rng, 4096, 64, decay=0.05)
    qs = _anisotropic(rng, 32, 64, decay=0.05)
    ref_ix, port_ix = _indexes(docs)
    ref_ix.enable_sketch(sketch_dim=24, cache=False)
    port_ix.enable_sketch(sketch_dim=24, cache=False)
    sk = _bf16(np.asarray(ref_ix._sketch[0], np.float32))[0]
    port_ix._sketch = (sk, _t(np.asarray(ref_ix._sketch[1])), *port_ix._sketch[2:])
    want = ref_ix.calibrate_sketch(qs, 10, recall_target=0.95)
    got = port_ix.calibrate_sketch(qs, 10, recall_target=0.95)
    assert got["probe_bins"] == want["probe_bins"] and got["recall"] == want["recall"]
    assert got["certified_frac"] == want["certified_frac"] and got["recall"] >= 0.95
    assert port_ix._sketch[3]["probe_by_k"][10] == got["probe_bins"]
    assert port_ix._sketch[3]["cert_by_k"][10] == got["certified_frac"]


def test_guaranteed_cert_floor_runs_exact_directly():
    rng = np.random.default_rng(21)
    docs = _normalize(rng.standard_normal((2048, 32)).astype(np.float32))
    ix = PortIndex.build(docs, [str(i) for i in range(2048)]).to_device("cpu", pad_multiple=256)
    ix.enable_sketch(sketch_dim=8, cache=False)
    ix._sketch[3]["cert_by_k"][10] = 0.0
    gv, gi = ix.search(docs[:6], 10, return_docids=False, approx="guaranteed")
    assert ix.last_guaranteed_direct and ix.last_guaranteed_route == "exact" and ix.last_certified.all()
    np.testing.assert_array_equal(gi, ix.search(docs[:6], 10, return_docids=False)[1])


def test_sketch_cache_is_shared_by_both_packages(tmp_path, monkeypatch):
    """sketch.npz written by the JAX package (with adaptive a_* keys) opens in
    the port without a refit; the port's rewrite keeps the a_* keys and
    opens in the JAX package without a refit."""
    import codemix_dense_retrieval_tpu.ops.sketch as ref_mod

    rng = np.random.default_rng(40)
    docs = _anisotropic(rng, 4096, 64, decay=0.05)
    qs = _anisotropic(rng, 32, 64, decay=0.05)
    PortIndex.build(docs, [f"d{i}" for i in range(4096)]).save(tmp_path / "idx")
    ref_ix = RefIndex.load(tmp_path / "idx")
    ref_ix.to_device(make_mesh(shard=1, tp=1), pad_multiple=256)
    ref_ix.enable_sketch(sketch_dim=24)
    ref_ix.calibrate_sketch(qs, 10, recall_target=0.9)
    ref_ix._adaptive_cal = {"probe_by_k": {10: 7}, "speedup_by_k": {10: 1.5}, "cert_by_k": {10: 0.25}}
    ref_ix._save_sketch_cache()
    ref_probe = ref_ix._sketch[3]["probe_by_k"][10]

    def no_refit(*a, **kw):
        raise AssertionError("refit should not happen on a cache hit")

    monkeypatch.setattr(port, "fit_sketch", no_refit)
    ix = PortIndex.load(tmp_path / "idx").to_device("cpu", pad_multiple=256)
    ix.enable_sketch(sketch_dim=24)
    assert ix._sketch[3]["probe_by_k"] == {10: ref_probe}
    np.testing.assert_array_equal(ix._sketch[2].numpy(), np.asarray(ref_ix._sketch[2]))
    ix.calibrate_sketch(qs, 5, recall_target=0.9)
    z = np.load(tmp_path / "idx" / "sketch.npz")
    assert sorted(z["probe_ks"].tolist()) == [5, 10]
    assert z["a_ks"].tolist() == [10] and z["a_probe_vals"].tolist() == [7]
    np.testing.assert_allclose(z["a_speedup_vals"], [1.5])

    monkeypatch.setattr(ref_mod, "fit_sketch", no_refit)
    again = RefIndex.load(tmp_path / "idx")
    again.to_device(make_mesh(shard=1, tp=1), pad_multiple=256)
    again.enable_sketch(sketch_dim=24)
    assert again._sketch[3]["probe_by_k"] == ix._sketch[3]["probe_by_k"]
    assert again._adaptive_cal["probe_by_k"] == {10: 7}
    # a cache for another count is ignored: the port refits
    monkeypatch.undo()
    PortIndex.build(docs[:4000], [f"d{i}" for i in range(4000)]).save(tmp_path / "idx2")
    (tmp_path / "idx2" / "sketch.npz").write_bytes((tmp_path / "idx" / "sketch.npz").read_bytes())
    fresh = PortIndex.load(tmp_path / "idx2").to_device("cpu", pad_multiple=256).enable_sketch(sketch_dim=24)
    assert fresh._sketch[3]["probe_by_k"] == {} and fresh._adaptive_cal["probe_by_k"] == {}


def test_sharded_sketch_search_int8_needs_scales():
    rng = np.random.default_rng(12)
    dv, _ = quantize_rows_np(_anisotropic(rng, 1024, 32))
    z = torch.zeros(1024, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="doc_scales"):
        sharded_topk_ip_sketch(torch.zeros(2, 32), _t(dv), torch.tensor([1024], dtype=torch.int32), z,
                               torch.zeros(1024), torch.zeros(32, 8), 5)


def test_vector_mix_runner_guaranteed_trec_identical_to_exact(tmp_path):
    """The --approx guaranteed contract: run files byte-identical to exact."""
    from codemix_dense_retrieval_torch.pipeline.runs import run_vector_mix_search

    rng = np.random.default_rng(30)
    n, d = 4096, 64
    docs = _anisotropic(rng, n, d, decay=0.05)
    qa = _anisotropic(rng, 12, d, decay=0.05)
    qb = _anisotropic(rng, 12, d, decay=0.05)
    qids = [f"q{i}" for i in range(12)]
    ix = PortIndex.build(docs, [f"d{i}" for i in range(n)]).to_device("cpu", pad_multiple=256)
    ix.enable_sketch(sketch_dim=16, probe_bins=16, cache=False)
    exact = run_vector_mix_search(ix, qids, qa, qb, [0.5], tmp_path / "exact", k=10, write_meta=True)
    cert = {}
    grt = run_vector_mix_search(ix, qids, qa, qb, [0.5], tmp_path / "grt", k=10, approx="guaranteed",
                                write_meta=True, cert_out=cert)
    assert exact[0.5].read_text() == grt[0.5].read_text()
    meta = json.loads((tmp_path / "grt" / "cm-alpha-0.5_meta.json").read_text())
    assert meta["approx"] == "guaranteed" and meta["certified_frac"] == 1.0 and cert == {0.5: 1.0}
    assert "approx" not in json.loads((tmp_path / "exact" / "cm-alpha-0.5_meta.json").read_text())


@pytest.mark.parametrize("mode", ["fast", "guaranteed"])
def test_cli_run_mix_approx_on_cpu(tmp_path, mode):
    """--approx through the CLI: guaranteed runs equal the exact runs, and
    the meta carries the certificate rate."""
    from codemix_dense_retrieval_torch.cli import main
    from codemix_dense_retrieval_torch.io.tsv import write_queries_tsv

    rng = np.random.default_rng(31)
    docs = _anisotropic(rng, 2048, 32, decay=0.05)
    PortIndex.build(docs, [f"d{i}" for i in range(2048)]).save(tmp_path / "ix")
    write_queries_tsv(tmp_path / "en.tsv", [(f"q{i}", f"english query {i}") for i in range(6)])
    write_queries_tsv(tmp_path / "zh.tsv", [(f"q{i}", f"other query {i}") for i in range(6)])
    common = ["run-mix", "--device", "cpu", "--index", str(tmp_path / "ix"), "--smoke_dim", "32",
              "--k", "7", "--query_tsv", f"en={tmp_path / 'en.tsv'}", f"zh={tmp_path / 'zh.tsv'}",
              "--cm_alphas", "0.5", "--query_cache", str(tmp_path / "cache")]
    main(common + ["--outdir", str(tmp_path / "exact")])
    main(common + ["--outdir", str(tmp_path / mode), "--approx", mode])
    meta = json.loads((tmp_path / mode / "cm-alpha-0.5_meta.json").read_text())
    assert meta["approx"] == ("True" if mode == "fast" else "guaranteed") and 0.0 <= meta["certified_frac"] <= 1.0
    lines = (tmp_path / mode / "cm-alpha-0.5.trec").read_text().splitlines()
    assert len(lines) == 6 * 7
    if mode == "guaranteed":
        assert meta["certified_frac"] == 1.0
        assert (tmp_path / mode / "cm-alpha-0.5.trec").read_text() == (
            tmp_path / "exact" / "cm-alpha-0.5.trec").read_text()
    assert (tmp_path / "ix" / "sketch.npz").exists()  # the fit is cached beside the store
