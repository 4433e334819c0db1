"""The int8 index path: kernel 4's plain version against the JAX package's
Pallas kernel (interpret mode), the int8 top-k entry points, the sharded
search's int8 routes, the index and the store, each against the JAX package
on the same numpy inputs.

Tolerance: none for ids. Int8 products are exact integers and both sides
rescale in the order (acc * d_scale) * q_scale, so scores are bit-equal,
except against the JAX package's jit-compiled search programs: XLA turns
``amax / 127`` into a multiply by the reciprocal there, so their query
scales may differ from eager JAX, numpy and the port by one f32 ulp, and the
scores rescaled by them by up to two (``ULP``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex as PortIndex
from codemix_dense_retrieval_torch.io.shards import ShardStore as PortStore
from codemix_dense_retrieval_torch.ops import topk as port
from codemix_dense_retrieval_torch.ops.quant import quantize_rows_np
from codemix_dense_retrieval_tpu.index.flat import DenseFlatIndex as RefIndex
from codemix_dense_retrieval_tpu.io.shards import ShardStore as RefStore
from codemix_dense_retrieval_tpu.ops import topk as ref
from codemix_dense_retrieval_tpu.parallel.mesh import make_mesh

NEG_INF = np.float32(np.finfo(np.float32).min)
ULP = dict(rtol=2.0 ** -22, atol=0)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["bin_major", "transposed"])
@pytest.mark.parametrize("bin_size", [8, 16])
def test_bin_scores_int8_plain_is_bit_equal_to_pallas(bin_size, layout, score_dtype):
    rng = np.random.default_rng(bin_size + 100)
    b, n, d, n_valid = 8, 1024, 64, 1000 - 13  # n_valid not a tile multiple
    qv, qs = quantize_rows_np(_unit(rng, b, d))
    dv, ds = quantize_rows_np(_unit(rng, n, d))
    jdt = jnp.float32 if score_dtype == "float32" else jnp.bfloat16
    s_ref, bm_ref = ref._bin_scores_pallas_int8(
        *map(jnp.asarray, (qv, qs, dv, ds)), bin_size, n_valid, tile_b=8, tile_n=512,
        interpret=True, score_dtype=jdt, bin_major=(layout == "bin_major"),
    )
    s_got, bm_got = port.bin_scores_int8(
        *map(torch.from_numpy, (qv, qs, dv, ds)), n_valid, bin_size,
        layout=layout, score_dtype=getattr(torch, score_dtype),
    )
    s_ref = np.asarray(s_ref).astype(np.float32)
    s_got = s_got.to(torch.float32).numpy()
    assert s_got.shape == s_ref.shape and bm_got.shape == bm_ref.shape
    np.testing.assert_array_equal(_bits(s_got), _bits(s_ref))
    np.testing.assert_array_equal(_bits(bm_got.numpy()), _bits(bm_ref))
    pad_rows = s_got[:, n_valid:] if layout == "bin_major" else s_got[n_valid:]
    assert (pad_rows == np.float32(NEG_INF) if score_dtype == "float32" else pad_rows < -1e38).all()


@pytest.mark.parametrize("layout", ["bin_major", "transposed"])
@pytest.mark.parametrize("bin_size", [8, 16])
@pytest.mark.parametrize("b", [1, 65, 129, 257])
def test_bin_scores_int8_plain_is_bit_equal_to_pallas_at_kernel_tile_edges(b, bin_size, layout):
    """The card's oracle for kernel 4 at the kernel's tile edges: one query,
    one past its 64- and 128-wide query tiles, two 256-query tiles; d = 192,
    one and a half 128-byte stages; n_valid inside the first 128-row tile,
    so every later tile is padding."""
    rng = np.random.default_rng(3000 + b)
    n, d, n_valid = 1024, 192, 100
    qv, qs = quantize_rows_np(_unit(rng, b, d))
    dv, ds = quantize_rows_np(_unit(rng, n, d))
    s_ref, bm_ref = ref._bin_scores_pallas_int8(
        *map(jnp.asarray, (qv, qs, dv, ds)), bin_size, n_valid, tile_b=b, tile_n=512,
        interpret=True, bin_major=(layout == "bin_major"),
    )
    s_got, bm_got = port.bin_scores_int8(*map(torch.from_numpy, (qv, qs, dv, ds)), n_valid, bin_size,
                                         layout=layout)
    s_got, bm_got = s_got.numpy(), bm_got.numpy()
    assert s_got.shape == np.shape(s_ref) and bm_got.shape == np.shape(bm_ref)
    np.testing.assert_array_equal(_bits(s_got), _bits(s_ref))
    np.testing.assert_array_equal(_bits(bm_got), _bits(bm_ref))
    if layout == "transposed":
        s_got, bm_got = s_got.T, bm_got.T
    assert (s_got[:, n_valid:] == NEG_INF).all()
    assert (bm_got[:, -(-n_valid // bin_size):] == NEG_INF).all()


def _int8_pair(seed, n=3000, d=64, b=16):
    rng = np.random.default_rng(seed)
    qs = _unit(rng, b, d)
    dv, ds = quantize_rows_np(_unit(rng, n, d))
    return qs, dv, ds


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("two_level", [False, True])
def test_topk_ip_bins_int8_matches_jax(two_level, k):
    """Single level (transposed) and two levels (bin-major), the port's two
    int8 routes."""
    qs, dv, ds = _int8_pair(k + 7 * two_level + 1)
    kw = dict(bin_size=8, super_size=4, tile_n=1024, two_level=two_level, n_valid=2900)
    rv, ri = ref.topk_ip_bins_int8(jnp.asarray(qs), jnp.asarray(dv), jnp.asarray(ds), k,
                                   interpret=True, bin_major=True, **kw)
    gv, gi = port.topk_ip_bins_int8(torch.from_numpy(qs), torch.from_numpy(dv),
                                    torch.from_numpy(ds), k, **kw)
    assert gi.shape == (16, k) and int(gi.max()) < 2900
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(_bits(gv.numpy()), _bits(rv))


@pytest.mark.parametrize("method", ["auto", "full", "bins_xla", "bins_pallas", "bins_two_level"])
def test_sharded_int8_search_matches_jax_for_every_method(method):
    from codemix_dense_retrieval_torch.parallel import sharded_search as port_ss
    from codemix_dense_retrieval_tpu.parallel import sharded_search as ref_ss

    rng = np.random.default_rng(9)
    docs, qs = _unit(rng, 2000, 32), _unit(rng, 6, 32)
    store = PortStore.build(docs, [str(i) for i in range(2000)], dtype="int8")
    (rows,), (counts,), rps = port_ss.shard_rows(store, torch.device("cpu"))
    (scales,) = port_ss.shard_row_sidecar(store.scales, torch.device("cpu"), rps)
    assert rows.dtype == torch.int8 and scales.shape == (rps,) and (scales[2000:] == 0).all()
    gv, gi = port_ss.sharded_topk_ip(torch.from_numpy(qs), rows, counts, 64, method=method,
                                     doc_scales=scales)
    mesh = make_mesh(shard=1, tp=1)
    rrows, rcounts, rrps = ref_ss.shard_rows(store.vectors, mesh)
    rscales = ref_ss.shard_row_sidecar(store.scales, mesh, rrps)
    rv, ri = ref_ss.sharded_topk_ip(jnp.asarray(qs), rrows, rcounts, 64, mesh=mesh,
                                    method=method, doc_scales=rscales, interpret=True)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), **ULP)
    with pytest.raises(ValueError, match="doc_scales"):
        port_ss.sharded_topk_ip(torch.from_numpy(qs), rows, counts, 64, method=method)


@pytest.mark.parametrize("query_block", [0, 4])
def test_int8_index_search_matches_jax(query_block):
    rng = np.random.default_rng(12)
    docs, qs = _unit(rng, 2500, 32), rng.standard_normal((10, 32)).astype(np.float32)
    ids = [f"d{i}" for i in range(2500)]
    ref_ix = RefIndex.build(docs, ids, dtype="int8").to_device(make_mesh(shard=1, tp=1))
    port_ix = PortIndex.build(docs, ids, dtype="int8").to_device("cpu")
    assert port_ix._docs_dev[0].dtype == torch.int8
    assert port_ix.search_kwargs["doc_scales"][0].dtype == torch.float32
    for k in (1, 30):
        rv, rd = ref_ix.search(qs, k, query_block=query_block)
        gv, gd = port_ix.search(qs, k, query_block=query_block)
        np.testing.assert_array_equal(gd, rd)
        np.testing.assert_allclose(gv, rv, **ULP)


def test_int8_stores_open_in_either_package(tmp_path):
    rng = np.random.default_rng(13)
    docs = _unit(rng, 500, 32)
    docs[7] = 0.0
    ids = [f"d{i}" for i in range(500)]
    PortStore.build(docs, ids, dtype="int8", lang="en").save(tmp_path / "p", rows_per_file=200)
    RefStore.build(docs, ids, dtype="int8", lang="zh").save(tmp_path / "r", rows_per_file=128)
    want_v, want_s = quantize_rows_np(docs)
    got_in_ref = RefStore.open(tmp_path / "p")
    got_in_port = PortStore.open(tmp_path / "r")
    for store, lang in ((got_in_ref, "en"), (got_in_port, "zh")):
        assert store.count == 500 and store.manifest.dtype == "int8" and store.manifest.lang == lang
        assert list(store.docids) == ids
        np.testing.assert_array_equal(np.asarray(store.vectors), want_v)
        np.testing.assert_array_equal(_bits(store.scales), _bits(want_s))
    assert PortStore.exists(tmp_path / "r") and not PortStore.exists(tmp_path / "missing")


def test_writer_quantizes_each_appended_batch(tmp_path):
    from codemix_dense_retrieval_torch.io.shards import ShardWriter

    rng = np.random.default_rng(14)
    docs = _unit(rng, 50, 16)
    w = ShardWriter(tmp_path / "s", 16, "int8", rows_per_file=20)
    w.append(docs[:30], [str(i) for i in range(30)])
    w.append(torch.from_numpy(docs[30:]), [str(i) for i in range(30, 50)])
    w.finalize()
    store = PortStore.open(tmp_path / "s")
    want_v, want_s = quantize_rows_np(docs)
    np.testing.assert_array_equal(np.asarray(store.vectors), want_v)
    np.testing.assert_array_equal(_bits(store.scales), _bits(want_s))
    assert [f["rows"] for f in store.manifest.files] == [20, 20, 10]


def test_bin_scores_int8_plain_is_exact_at_d2048():
    """All-±127 rows at d = 2048: |acc| reaches 127^2 * 2048 > 2^24, past
    what one f32 product sum holds exactly; the plain version still equals
    the int64 products, rescaled in the kernel's order."""
    rng = np.random.default_rng(15)
    qv = (rng.integers(0, 2, (4, 2048)) * 254 - 127).astype(np.int8)
    dv = (rng.integers(0, 2, (64, 2048)) * 254 - 127).astype(np.int8)
    qv[0], dv[0] = 127, 127
    qs = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    ds = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    acc = (qv.astype(np.int64) @ dv.astype(np.int64).T).astype(np.float32)
    want = acc * ds[None, :] * qs[:, None]
    s, bm = port.bin_scores_int8_plain(*map(torch.from_numpy, (qv, qs, dv, ds)), 64, 8)
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(bm.numpy()), _bits(want.reshape(4, 8, 8).max(axis=2)))


def test_sharded_int8_bins_xla_pads_a_ragged_tail_up():
    """1,000 rows with bin size 16: the plain bins route pads the tail up to
    1,008 with NEG_INF, so the last rows stay selectable (ids equal "full")."""
    from codemix_dense_retrieval_torch.parallel import sharded_search as port_ss

    rng = np.random.default_rng(16)
    docs = _unit(rng, 1000, 32)
    qs = docs[-3:] + 0.01 * rng.standard_normal((3, 32)).astype(np.float32)  # best rows at the tail
    store = PortStore.build(docs, [str(i) for i in range(1000)], dtype="int8")
    (rows,), (counts,), rps = port_ss.shard_rows(store, torch.device("cpu"), pad_multiple=1000)
    (scales,) = port_ss.shard_row_sidecar(store.scales, torch.device("cpu"), rps)
    assert rps == 1000
    q = torch.from_numpy(qs)
    _, want = port_ss.sharded_topk_ip(q, rows, counts, 20, method="full", doc_scales=scales)
    _, got = port_ss.sharded_topk_ip(q, rows, counts, 20, method="bins_xla", bin_size=16,
                                     doc_scales=scales)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got[:, 0].tolist() == [997, 998, 999]


@pytest.mark.parametrize("method", ["bins_rescore", "bins_palas"])
def test_sharded_int8_unknown_method_raises_before_scoring(method, monkeypatch):
    """A method the routing does not take is refused up front: no int8
    scores over the whole shard are computed first (the plain routes'
    scoring is ``ops/topk.py``'s, where the route is decided)."""
    from codemix_dense_retrieval_torch.parallel import sharded_search as port_ss

    def no_scores(*args, **kwargs):
        raise AssertionError("scored the shard before checking the method")

    monkeypatch.setattr(port, "quantize_rows", no_scores)
    monkeypatch.setattr(port, "bin_scores_int8_plain", no_scores)
    monkeypatch.setattr(port, "bin_scores_int8", no_scores)
    rng = np.random.default_rng(17)
    store = PortStore.build(_unit(rng, 300, 16), [str(i) for i in range(300)], dtype="int8")
    (rows,), (counts,), rps = port_ss.shard_rows(store, torch.device("cpu"))
    (scales,) = port_ss.shard_row_sidecar(store.scales, torch.device("cpu"), rps)
    q = torch.from_numpy(_unit(rng, 2, 16))
    with pytest.raises(ValueError, match="unknown method"):
        port_ss.sharded_topk_ip(q, rows, counts, 5, method=method, doc_scales=scales)
