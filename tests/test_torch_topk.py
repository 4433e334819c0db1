"""ops/topk.py: the port's plain phase 1 (kernel A's plain version) against
the JAX package's Pallas kernels in interpret mode, and the port's top-k
entry points against the JAX package's on the same numpy inputs.

Tolerances: f32 scores 1e-5 abs; bf16 scores one bf16 ulp (the two sides
sum the same exact bf16 products in different orders, which can move a
value across a bf16 rounding boundary); ids exactly equal.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codemix_dense_retrieval_torch.ops import topk as port
from codemix_dense_retrieval_tpu.ops import topk as ref

NEG_INF = np.float32(np.finfo(np.float32).min)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _bf16_pair(x):
    """The same bf16 values for both sides."""
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


# --------------------------------------------------------------------------
# phase 1: plain bin_scores vs the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["bin_major", "transposed"])
@pytest.mark.parametrize("bin_size", [8, 16])
def test_bin_scores_plain_matches_pallas(bin_size, layout, score_dtype):
    rng = np.random.default_rng(bin_size)
    b, n, d, n_valid = 8, 1024, 64, 1000 - 13  # n_valid not a tile multiple
    qj, qt = _bf16_pair(_unit(rng, b, d))
    dj, dt = _bf16_pair(_unit(rng, n, d))
    jdt = jnp.float32 if score_dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, score_dtype)
    fn = ref._bin_scores_pallas_bm if layout == "bin_major" else ref._bin_scores_pallas
    s_ref, bm_ref = fn(qj, dj, bin_size, n_valid, tile_b=8, tile_n=512,
                       interpret=True, score_dtype=jdt)
    s_got, bm_got = port.bin_scores(qt, dt, n_valid, bin_size, layout=layout, score_dtype=tdt)
    assert s_got.dtype == tdt and bm_got.dtype == torch.float32
    s_ref = np.asarray(s_ref).astype(np.float32)
    s_got = s_got.to(torch.float32).numpy()
    bm_ref, bm_got = np.asarray(bm_ref), bm_got.numpy()
    assert s_got.shape == s_ref.shape and bm_got.shape == bm_ref.shape
    rows = (np.arange(b)[:, None] * 0 + np.arange(n)[None, :])
    if layout == "transposed":
        rows = rows.T
    pad = rows >= n_valid
    pad_value = np.float32(NEG_INF) if score_dtype == "float32" else np.float32(
        NEG_INF.astype(ml_dtypes.bfloat16))
    assert (s_got[pad] == pad_value).all() and (s_ref[pad] == pad_value).all()
    if score_dtype == "float32":
        np.testing.assert_allclose(s_got[~pad], s_ref[~pad], atol=1e-5, rtol=0)
    else:
        ulp = np.abs(s_ref[~pad]) * 2.0 ** -7 + 1e-30
        assert (np.abs(s_got[~pad] - s_ref[~pad]) <= ulp).all()
    live = bm_ref > NEG_INF
    assert (bm_got[~live] == NEG_INF).all()
    np.testing.assert_allclose(bm_got[live], bm_ref[live], atol=1e-5, rtol=0)


@pytest.mark.parametrize("bin_size", [8, 16])
@pytest.mark.parametrize("b", [1, 7, 64, 130])
def test_bin_scores_plain_transposed_across_query_counts(b, bin_size):
    """The transposed plain version at the query counts the card holds
    kernel 2 to: one query, an odd count, a count that fills the kernel's
    64-wide query tile and one past its 128-wide tile."""
    rng = np.random.default_rng(1000 + b)
    n, d, n_valid = 1024, 64, 1000 - 13
    qj, qt = _bf16_pair(_unit(rng, b, d))
    dj, dt = _bf16_pair(_unit(rng, n, d))
    s_ref, bm_ref = ref._bin_scores_pallas(qj, dj, bin_size, n_valid, tile_n=512, interpret=True)
    s_got, bm_got = port.bin_scores(qt, dt, n_valid, bin_size, layout="transposed")
    assert s_got.shape == (n, b) and bm_got.shape == (n // bin_size, b)
    s_ref, bm_ref = np.asarray(s_ref), np.asarray(bm_ref)
    s_got, bm_got = s_got.numpy(), bm_got.numpy()
    assert (s_got[n_valid:] == NEG_INF).all() and (bm_got[-(-n_valid // bin_size):] == NEG_INF).all()
    np.testing.assert_allclose(s_got[:n_valid], s_ref[:n_valid], atol=1e-5, rtol=0)
    np.testing.assert_allclose(bm_got, bm_ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bin_size", [8, 16])
@pytest.mark.parametrize("b", [1, 65, 129, 257])
def test_bin_scores_plain_bin_major_at_kernel_tile_edges(b, bin_size):
    """The bin-major plain version (the card's oracle for kernel A) at the
    kernel's tile edges: one query, one past its 64- and 128-wide query
    tiles, two 256-query tiles; d = 96, half of a 64-dim chunk; n_valid
    inside the first 128-row tile, so every later tile is padding."""
    rng = np.random.default_rng(2000 + b)
    n, d, n_valid = 1024, 96, 100
    qj, qt = _bf16_pair(_unit(rng, b, d))
    dj, dt = _bf16_pair(_unit(rng, n, d))
    s_ref, bm_ref = ref._bin_scores_pallas_bm(qj, dj, bin_size, n_valid, tile_n=512, interpret=True)
    s_got, bm_got = port.bin_scores(qt, dt, n_valid, bin_size, layout="bin_major")
    assert s_got.shape == (b, n) and bm_got.shape == (b, n // bin_size)
    s_ref, bm_ref = np.asarray(s_ref), np.asarray(bm_ref)
    s_got, bm_got = s_got.numpy(), bm_got.numpy()
    first_pad = -(-n_valid // bin_size)
    assert (s_got[:, n_valid:] == NEG_INF).all() and (bm_got[:, first_pad:] == NEG_INF).all()
    np.testing.assert_allclose(s_got[:, :n_valid], s_ref[:, :n_valid], atol=1e-5, rtol=0)
    np.testing.assert_allclose(bm_got, bm_ref, atol=1e-5, rtol=0)


def test_bin_scores_rejects_unknown_layout():
    q = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        port.bin_scores(q, torch.zeros(16, 8), 16, 8, layout="rows")


# --------------------------------------------------------------------------
# top-k entry points vs the JAX package
# --------------------------------------------------------------------------

def _run_both(name, qs, docs, k, **kw):
    jfn = {
        "full": lambda q, d: ref.topk_ip_full(q, d, k),
        "bins": lambda q, d: ref.topk_ip_bins(q, d, k, bin_size=16, tile_n=1024, **kw),
        "two_level": lambda q, d: ref.topk_ip_bins_two_level(
            q, d, k, bin_size=8, super_size=4, tile_n=1024, **kw),
        "auto": lambda q, d: ref.topk_ip(q, d, k, method="auto"),
    }[name]
    tfn = {
        "full": lambda q, d: port.topk_ip_full(q, d, k),
        "bins": lambda q, d: port.topk_ip_bins(q, d, k, bin_size=16, tile_n=1024, **kw),
        "two_level": lambda q, d: port.topk_ip_bins_two_level(
            q, d, k, bin_size=8, super_size=4, tile_n=1024, **kw),
        "auto": lambda q, d: port.topk_ip(q, d, k, method="auto"),
    }[name]
    rv, ri = jfn(jnp.asarray(qs), jnp.asarray(docs))
    gv, gi = tfn(torch.from_numpy(qs), torch.from_numpy(docs))
    return np.asarray(rv), np.asarray(ri), gv.numpy(), gi.numpy()


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("name", ["full", "bins", "two_level", "auto"])
def test_topk_matches_jax(name, k):
    rng = np.random.default_rng(k)
    qs, docs = _unit(rng, 16, 64), _unit(rng, 3000, 64)
    rv, ri, gv, gi = _run_both(name, qs, docs, k)
    assert gi.shape == (16, k)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_allclose(gv, rv, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["full", "bins", "two_level"])
def test_tie_break_lower_id_wins(name):
    """Duplicate rows with exactly representable values: every tie is exact
    on both sides, so ids must agree exactly and ascend within ties."""
    rng = np.random.default_rng(7)
    base = rng.integers(-2, 3, size=(4, 16)).astype(np.float32) / 4
    docs = base[rng.integers(0, 4, size=2048)]
    qs = base[:3] * 0.5
    rv, ri, gv, gi = _run_both(name, qs, docs, 100)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gv, rv)
    for row_v, row_i in zip(gv, gi):
        tied = row_v[1:] == row_v[:-1]
        assert (row_i[1:][tied] > row_i[:-1][tied]).all()


@pytest.mark.parametrize("name", ["bins", "two_level"])
def test_padding_never_selected(name):
    """N not a tile multiple and every real score negative: zero-score pad
    rows must never be selected."""
    rng = np.random.default_rng(11)
    docs = -np.abs(_unit(rng, 1000, 16))
    qs = np.abs(_unit(rng, 4, 16))
    rv, ri, gv, gi = _run_both(name, qs, docs, 100)
    assert gi.max() < 1000
    np.testing.assert_array_equal(gi, ri)
    oracle = np.argsort(-(qs @ docs.T), axis=1, kind="stable")[:, :100]
    np.testing.assert_array_equal(gi, oracle)


@pytest.mark.parametrize("n_valid", [700, 1000])
def test_n_valid_masks_tail_rows(n_valid):
    rng = np.random.default_rng(n_valid)
    qs, docs = _unit(rng, 4, 32), _unit(rng, 2048, 32)
    rv, ri, gv, gi = _run_both("two_level", qs, docs, 50, n_valid=n_valid)
    assert gi.max() < n_valid
    np.testing.assert_array_equal(gi, ri)


@pytest.mark.parametrize("name", ["bins", "two_level", "full"])
def test_k_greater_than_n_valid_raises(name):
    rng = np.random.default_rng(3)
    qs, docs = _unit(rng, 2, 16), _unit(rng, 64, 16)
    fn = {
        "bins": lambda: port.topk_ip_bins(torch.from_numpy(qs), torch.from_numpy(docs), 100),
        "two_level": lambda: port.topk_ip_bins_two_level(
            torch.from_numpy(qs), torch.from_numpy(docs), 100),
        "full": lambda: port.topk_ip(torch.from_numpy(qs), torch.from_numpy(docs), 100, method="full"),
    }[name]
    with pytest.raises(ValueError, match="k=100"):
        fn()


def test_bins_rescore_routes_to_the_rescore_search():
    """``method="bins_rescore"`` routes to the rescore search (kernel 5's
    path) and gives the exact ids of a full sort."""
    rng = np.random.default_rng(4)
    qs, docs = torch.from_numpy(_unit(rng, 3, 16)), torch.from_numpy(_unit(rng, 64, 16))
    vals, ids = port.topk_ip(qs, docs, 4, method="bins_rescore")
    want_vals, want_ids = port.topk_ip_full(qs, docs, 4)
    torch.testing.assert_close(ids, want_ids, rtol=0, atol=0)
    torch.testing.assert_close(vals, want_vals, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("method", ["auto", "full", "bins_xla", "bins_pallas", "bins_two_level"])
def test_shard_topk_matches_jax_sharded_search_over_one_shard(method, dtype):
    """``shard_topk``, the per-shard entry of the sharded search, against
    the JAX package's ``sharded_topk_ip`` over a one-shard mesh: every
    method, f32 and int8 rows, 2,900 valid rows of 3,072, the rows past
    them copies of the queries (they would win unmasked). Ids exactly; f32
    values within 1e-5, int8 values within two f32 ulps (the JAX program's
    query scales, as in tests/test_torch_int8.py)."""
    import jax

    from codemix_dense_retrieval_torch.ops.quant import quantize_rows_np
    from codemix_dense_retrieval_tpu.parallel import sharded_search as ref_ss
    from codemix_dense_retrieval_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(40)
    n, k = 2900, 40
    qs = _unit(rng, 6, 32)
    docs = np.concatenate([_unit(rng, n, 32), np.tile(qs, (29, 1))[: 3072 - n]])
    scales = None
    if dtype == "int8":
        docs, scales = quantize_rows_np(docs)
    mesh = make_mesh(shard=1, tp=1)
    rrows, rcounts, rps = ref_ss.shard_rows(docs, mesh, pad_multiple=1024)
    assert rps == 3072
    rcounts = jax.device_put(np.array([n], np.int32), rcounts.sharding)
    rsc = None if scales is None else ref_ss.shard_row_sidecar(scales, mesh, rps)
    rv, ri = ref_ss.sharded_topk_ip(jnp.asarray(qs), rrows, rcounts, k, mesh=mesh, method=method,
                                    doc_scales=rsc, interpret=True)
    gv, gi = port.shard_topk(
        torch.from_numpy(qs), torch.from_numpy(np.array(rrows)), k,
        n_valid=torch.tensor([n], dtype=torch.int32),
        doc_scales=None if rsc is None else torch.from_numpy(np.array(rsc)), method=method,
    )
    assert gi.shape == (6, k) and int(gi.max()) < n
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    tol = dict(rtol=0, atol=1e-5) if dtype == "float32" else dict(rtol=2.0 ** -22, atol=0)
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), **tol)


def test_auto_routing_thresholds(monkeypatch):
    seen = []
    monkeypatch.setattr(port, "topk_ip_full", lambda *a, **k: seen.append("full"))
    monkeypatch.setattr(port, "topk_ip_bins", lambda *a, **k: seen.append("bins"))
    monkeypatch.setattr(port, "topk_ip_bins_two_level", lambda *a, **k: seen.append("two"))
    for n in (16_383, 16_384, 262_143, 262_144):
        port.topk_ip(torch.zeros(1, 2), torch.zeros(n, 2), 1)
    assert seen == ["full", "bins", "bins", "two"]
