"""io/shards.py + index/flat.py: one store format for both packages, and
the same exact search results (ids equal, values 1e-5 abs)."""

import logging

import ml_dtypes
import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex as PortIndex
from codemix_dense_retrieval_torch.io.shards import ShardStore as PortStore
from codemix_dense_retrieval_tpu.index.flat import DenseFlatIndex as RefIndex
from codemix_dense_retrieval_tpu.io.shards import ShardStore as RefStore
from codemix_dense_retrieval_tpu.parallel.mesh import make_mesh


def _data(seed, n=3000, d=32, b=10):
    rng = np.random.default_rng(seed)
    docs = rng.standard_normal((n, d)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    qs = rng.standard_normal((b, d)).astype(np.float32)
    return docs, qs, [f"d{i}" for i in range(n)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
def test_store_written_by_port_opens_in_jax(tmp_path, dtype):
    docs, _, ids = _data(0, n=500)
    PortStore.build(docs, ids, dtype=dtype, lang="en", encoder="bge").save(
        tmp_path / "s", rows_per_file=200)
    ref = RefStore.open(tmp_path / "s")
    want = RefStore.build(docs, ids, dtype=dtype).vectors
    assert ref.count == 500 and ref.manifest.lang == "en" and ref.docids == ids
    assert ref.derived_ids == ids
    np.testing.assert_array_equal(
        np.asarray(ref.vectors).view(np.uint8), np.asarray(want).view(np.uint8))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_store_written_by_jax_opens_in_port(tmp_path, dtype):
    docs, _, ids = _data(1, n=500)
    RefStore.build(docs, ids, dtype=dtype, lang="zh").save(tmp_path / "s", rows_per_file=128)
    got = PortStore.open(tmp_path / "s")
    assert got.count == 500 and got.docids == ids and got.manifest.lang == "zh"
    want = docs.astype(ml_dtypes.bfloat16).astype(np.float32) if dtype == "bfloat16" else docs
    np.testing.assert_array_equal(got.rows().to(torch.float32).numpy(), want)


def _search_both(docs, ids, qs, k, **kw):
    ref = RefIndex.build(docs, ids).to_device(make_mesh(shard=1, tp=1))
    port = PortIndex.build(docs, ids).to_device("cpu")
    rv, rd = ref.search(qs, k, **kw)
    gv, gd = port.search(qs, k, **kw)
    return rv, rd, gv, gd


@pytest.mark.parametrize("k", [1, 10, 100])
def test_search_gives_the_same_docids(k):
    docs, qs, ids = _data(2)
    rv, rd, gv, gd = _search_both(docs, ids, qs, k)
    assert gd.shape == (10, k)
    np.testing.assert_array_equal(gd, rd)
    np.testing.assert_allclose(gv, rv, atol=1e-5, rtol=0)


def test_query_block_with_ragged_tail_matches_one_block():
    docs, qs, ids = _data(3)
    port = PortIndex.build(docs, ids).to_device("cpu")
    v0, d0 = port.search(qs, 20)
    v1, d1 = port.search(qs, 20, query_block=4)  # 10 = 4 + 4 + 2 (padded)
    np.testing.assert_array_equal(d1, d0)
    # the CPU GEMM's summation order depends on the batch, so scores may move by an ulp
    np.testing.assert_allclose(v1, v0, rtol=0, atol=1e-6)
    rv, rd, gv, gd = _search_both(docs, ids, qs, 20, query_block=4)
    np.testing.assert_array_equal(gd, rd)


def test_k_is_clamped_with_a_warning(caplog):
    docs, qs, ids = _data(4, n=40)
    port = PortIndex.build(docs, ids).to_device("cpu")
    with caplog.at_level(logging.WARNING, logger="cdr.index"):
        vals, got = port.search(qs, 64)
    assert got.shape == (10, 40)
    assert "clamped to 40" in caplog.text
    assert sorted(got[0]) == sorted(ids)


def test_dim_mismatch_raises():
    docs, qs, ids = _data(5, n=64)
    port = PortIndex.build(docs, ids).to_device("cpu")
    with pytest.raises(ValueError, match="query dim 16 != index dim 32"):
        port.search(np.zeros((2, 16), np.float32), 5)


def test_approx_is_refused():
    """An unknown approx value is refused; "adaptive" (ported) gives the
    exact results."""
    docs, qs, ids = _data(6, n=64)
    port = PortIndex.build(docs, ids).to_device("cpu")
    with pytest.raises(ValueError, match="approx must be"):
        port.search(qs, 5, approx="approximately")
    ev, ed = port.search(qs, 5)
    av, ad = port.search(qs, 5, approx="adaptive")
    np.testing.assert_array_equal(ad, ed)
    np.testing.assert_array_equal(av, ev)


def test_queries_are_cast_to_the_index_dtype():
    """Searching f32 queries against a bf16 index equals searching their
    bf16-rounded copies."""
    docs, qs, ids = _data(7)
    port = PortIndex.build(docs, ids).to_device("cpu")
    qs_bf16 = torch.from_numpy(qs).to(torch.bfloat16).to(torch.float32).numpy()
    v0, d0 = port.search(qs, 30, return_docids=False)
    v1, d1 = port.search(qs_bf16, 30, return_docids=False)
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(v0, v1)


@pytest.mark.parametrize("method", ["auto", "full", "bins_xla", "bins_pallas", "bins_two_level"])
def test_every_sharded_method_gives_the_exact_ids(method):
    from codemix_dense_retrieval_torch.parallel.sharded_search import shard_rows, sharded_topk_ip

    docs, qs, ids = _data(8, n=2000)
    store = PortStore.build(docs, ids)
    (rows,), (counts,), rps = shard_rows(store, torch.device("cpu"))
    assert rps == 2048 and int(counts[0]) == 2000 and (rows[2000:] == 0).all()
    q = torch.from_numpy(qs).to(torch.bfloat16)
    vals, gids = sharded_topk_ip(q, rows, counts, 64, method=method)
    scores = q.float() @ rows[:2000].float().T
    want = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :64]
    torch.testing.assert_close(gids, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="rows_per_shard"):
        sharded_topk_ip(q, rows, counts, 4096, method=method)
