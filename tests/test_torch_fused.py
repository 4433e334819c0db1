"""pipeline/fused.py: the port's fused alpha sweep (``device="cpu"``) against
the JAX package's on the same numpy inputs (1-device mesh, Pallas in
interpret mode): bf16, int8, f32 and f16 indexes, the bilingual collapse,
the sketch tier and its guaranteed escalation. Ids equal, values and
metrics within 1e-6 (both sum in f32, in another order); the fused ids
equal the port's unfused run; a small hub clamps k_raw with a warning."""

import logging

import ml_dtypes
import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex as PortIndex
from codemix_dense_retrieval_torch.ops.mix import mix_and_renorm
from codemix_dense_retrieval_torch.pipeline import fused as port
from codemix_dense_retrieval_tpu.index.flat import DenseFlatIndex as RefIndex
from codemix_dense_retrieval_tpu.parallel.mesh import make_mesh
from codemix_dense_retrieval_tpu.pipeline import fused as ref

ALPHAS = [0.0, 0.3, 0.5, 1.0]


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _aniso(rng, n, d, decay=0.05):
    return _unit(rng.standard_normal((n, d)) * np.exp(-decay * np.arange(d)))


def _indexes(docs, dtype="bfloat16", pad=256):
    ids = [f"d{i}" for i in range(len(docs))]
    ref_ix = RefIndex.build(docs, ids, dtype=dtype).to_device(make_mesh(shard=1, tp=1), pad_multiple=pad)
    port_ix = PortIndex.build(docs, ids, dtype=dtype).to_device("cpu", pad_multiple=pad)
    return ref_ix, port_ix


def _sweeps(ref_ix, port_ix, primary, secondary, k, alphas=ALPHAS, ref_sketch=None, port_sketch=None, **kw):
    rv, ri, rm, rc = ref.fused_alpha_sweep(
        primary, secondary, alphas, ref_ix._docs_dev, ref_ix._counts_dev, k, mesh=ref_ix.mesh,
        search_kwargs=ref_ix.search_kwargs, sketch=ref_sketch, **kw)
    pv, pi, pm, pc = port.fused_alpha_sweep(
        primary, secondary, alphas, port_ix._docs_dev, port_ix._counts_dev, k,
        search_kwargs=port_ix.search_kwargs, sketch=port_sketch, query_block=8, **kw)
    return (np.asarray(rv), np.asarray(ri), rm, rc), (pv.numpy(), pi.numpy(), pm, pc)


def _assert_same(r, p):
    rv, ri, rm, _ = r
    pv, pi, pm, _ = p
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pv, rv, rtol=0, atol=1e-6)
    if rm is None:
        assert pm is None
        return
    assert sorted(pm) == sorted(rm)
    for name in rm:
        np.testing.assert_allclose(pm[name].numpy(), np.asarray(rm[name]), rtol=0, atol=1e-6, err_msg=name)


def _queries(rng, docs, b, rel):
    """Secondary queries near their relevant rows, primary ones random."""
    secondary = _unit(docs[rel] + 0.1 * rng.standard_normal((b, docs.shape[1])))
    primary = _unit(rng.standard_normal((b, docs.shape[1])))
    return primary, secondary


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32", "float16"])
def test_sweep_equals_jax_and_the_unfused_run(dtype):
    rng = np.random.default_rng(0)
    n, d, b, k = 1800, 32, 12, 20
    docs = _unit(rng.standard_normal((n, d)))
    rel = rng.choice(n, size=b, replace=False)
    primary, secondary = _queries(rng, docs, b, rel)
    rel_mat = np.stack([rel, (rel + 1) % n], axis=1).astype(np.int32)
    rel_mat[0, 1] = -1
    ref_ix, port_ix = _indexes(docs, dtype)
    r, p = _sweeps(ref_ix, port_ix, primary, secondary, k, rel_ids=rel_mat, metric_extra_zero_queries=1)
    _assert_same(r, p)
    assert float(p[2]["RR@10"][-1]) > 0.8  # alpha = 1: the secondary queries find their rows
    assert p[3] is None
    # the fused ids are the unfused search's, block for block
    for ai, alpha in enumerate(ALPHAS):
        q = mix_and_renorm(torch.from_numpy(primary), torch.from_numpy(secondary), alpha)
        _, want = port_ix.search(q, k, return_docids=False, query_block=8)
        np.testing.assert_array_equal(p[1][ai], want, err_msg=str(alpha))


def test_collapse_sweep_equals_jax():
    rng = np.random.default_rng(1)
    n1, d, b, k = 700, 32, 10, 15
    docs_a = _unit(rng.standard_normal((n1, d)))
    docs_b = _unit(docs_a + 0.3 * rng.standard_normal((n1, d)))
    hub = np.concatenate([docs_a, docs_b])
    rel = rng.choice(n1, size=b, replace=False)
    primary, secondary = _queries(rng, docs_b, b, rel)
    ref_ix, port_ix = _indexes(hub)
    r, p = _sweeps(ref_ix, port_ix, primary, secondary, k, rel_ids=rel[:, None].astype(np.int32),
                   collapse_n_first=n1)
    _assert_same(r, p)
    assert p[1].shape == (len(ALPHAS), b, k) and p[1].max() < n1
    assert float(p[2]["RR@10"][-1]) == pytest.approx(1.0)


def test_small_hub_clamps_k_raw_with_a_warning(caplog):
    rng = np.random.default_rng(2)
    n1, d, b = 96, 16, 4
    docs_a = _unit(rng.standard_normal((n1, d)))
    ref_ix, port_ix = _indexes(np.concatenate([docs_a, docs_a]), pad=64)
    q = _unit(rng.standard_normal((b, d)))
    with caplog.at_level(logging.WARNING, logger="cdr.fused"):
        pv, pi, _, _ = port.fused_alpha_sweep(q, q, [0.5], port_ix._docs_dev, port_ix._counts_dev, 150,
                                              collapse_n_first=n1)
    assert any("clamped to 192" in rec.getMessage() for rec in caplog.records)
    rv, ri, _, _ = ref.fused_alpha_sweep(q, q, [0.5], ref_ix._docs_dev, ref_ix._counts_dev, 150,
                                         mesh=ref_ix.mesh, collapse_n_first=n1)
    assert pi.shape == (1, b, 150) == np.asarray(ri).shape
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    assert (pi[:, :, n1:] == -1).all()  # fewer distinct bases than k: padding


def _shared_sketch(ref_ix, port_ix):
    """Arm both sketch tiers with the JAX package's sidecar, so ids and
    certificates compare exactly."""
    ref_ix.enable_sketch(sketch_dim=24, probe_bins=32, cache=False)
    port_ix.enable_sketch(sketch_dim=24, probe_bins=32, cache=False)
    sk = np.asarray(ref_ix._sketch[0], np.float32).astype(ml_dtypes.bfloat16)
    sk_t = torch.from_numpy(sk.view(np.int16).copy()).view(torch.bfloat16)
    port_ix._sketch = (sk_t, torch.from_numpy(np.array(ref_ix._sketch[1])), *port_ix._sketch[2:])
    np.testing.assert_array_equal(port_ix._sketch[2].numpy(), np.asarray(ref_ix._sketch[2]))


@pytest.mark.parametrize("collapse", [False, True])
def test_sketch_sweep_certificates_equal_jax(collapse):
    rng = np.random.default_rng(3)
    n, d, b, k = 1024, 64, 12, 6
    docs = _aniso(rng, n, d)
    hub = _unit(np.concatenate([docs, docs * 0.9 + 0.01 / np.sqrt(d)])) if collapse else docs
    ref_ix, port_ix = _indexes(hub)
    _shared_sketch(ref_ix, port_ix)
    primary = _aniso(rng, b, d)
    secondary = _unit(docs[rng.choice(n, b, replace=False)] + 0.05 * _aniso(rng, b, d))
    n_first = n if collapse else None
    r, p = _sweeps(ref_ix, port_ix, primary, secondary, k, collapse_n_first=n_first,
                   ref_sketch=ref_ix._sketch, port_sketch=port_ix._sketch)
    _assert_same(r, p)
    cert = p[3].numpy()
    np.testing.assert_array_equal(cert, np.asarray(r[3]))
    assert cert.any() and not cert.all()
    # certified rows are the exact sweep's
    _, ei, _, _ = port.fused_alpha_sweep(primary, secondary, ALPHAS, port_ix._docs_dev, port_ix._counts_dev, k,
                                         search_kwargs=port_ix.search_kwargs, collapse_n_first=n_first)
    np.testing.assert_array_equal(p[1][cert], ei.numpy()[cert])


@pytest.mark.parametrize("collapse", [False, True])
def test_guaranteed_sweep_equals_the_exact_sweep(collapse):
    rng = np.random.default_rng(4)
    n, d, b, k = 1024, 64, 12, 6
    docs = _aniso(rng, n, d)
    hub = _unit(np.concatenate([docs, docs * 0.9 + 0.01 / np.sqrt(d)])) if collapse else docs
    ref_ix, port_ix = _indexes(hub)
    _shared_sketch(ref_ix, port_ix)
    primary = _aniso(rng, b, d)
    secondary = _unit(docs[rng.choice(n, b, replace=False)] + 0.05 * _aniso(rng, b, d))
    common = dict(rel_ids=np.arange(b)[:, None].astype(np.int32), collapse_n_first=n if collapse else None)
    ev, ei, em, _ = port.fused_alpha_sweep(primary, secondary, ALPHAS, port_ix._docs_dev, port_ix._counts_dev, k,
                                           search_kwargs=port_ix.search_kwargs, **common)
    gv, gi, gm, cert = port.fused_alpha_sweep_guaranteed(
        primary, secondary, ALPHAS, port_ix._docs_dev, port_ix._counts_dev, k, sketch=port_ix._sketch,
        search_kwargs=port_ix.search_kwargs, query_block=8, **common)
    rv, ri, rm, rcert = ref.fused_alpha_sweep_guaranteed(
        primary, secondary, ALPHAS, ref_ix._docs_dev, ref_ix._counts_dev, k, mesh=ref_ix.mesh,
        sketch=ref_ix._sketch, search_kwargs=ref_ix.search_kwargs, **common)
    assert not cert.all()  # escalation happened
    np.testing.assert_array_equal(cert, rcert)
    np.testing.assert_array_equal(gi, ei.numpy())
    # certified rows carry the sketch rescore's scores, summed in another
    # order than the exact kernel's
    np.testing.assert_allclose(gv, ev.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_allclose(gv, rv, rtol=0, atol=1e-6)
    for name in em:
        np.testing.assert_array_equal(gm[name], em[name].numpy(), err_msg=name)
        np.testing.assert_allclose(gm[name], rm[name], rtol=0, atol=1e-6, err_msg=name)


def test_fit_query_block_cuts_blocks_to_the_card(monkeypatch):
    from codemix_dense_retrieval_torch.parallel import sharded_search as ss

    hub_rows = 17_684_480  # the bilingual hub at the paper's size, padded
    assert ss.fit_query_block(1024, 512, hub_rows, "cpu") == 1024
    gb = 10**9
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (43 * gb, 80 * gb))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 2 * gb)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 1 * gb)
    # 44 GB free x 0.75 / (17.7M rows x 4.5 bytes) = 414 queries -> 256
    assert ss.fit_query_block(1024, 512, hub_rows, "cuda") == 256
    assert ss.fit_query_block(0, 512, hub_rows, "cuda") == 256
    assert ss.fit_query_block(128, 512, hub_rows, "cuda") == 128
    assert ss.fit_query_block(1024, 300, hub_rows, "cuda") == 1024  # 300 queries fit in one block
    assert ss.fit_query_block(1024, 512, 131_072, "cuda") == 1024
    assert ss.fit_query_block(1024, 512, 10**13, "cuda") == 1  # not one query fits: one at a time


def test_search_blocks_pads_the_tail_block_and_cuts_it_off():
    from codemix_dense_retrieval_torch.parallel.sharded_search import search_blocks

    q = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    shapes = []

    def search(blk):
        shapes.append(tuple(blk.shape))
        return blk.sum(dim=1), blk[:, :2]

    s, first2 = search_blocks(q, 4, 1024, search)
    assert shapes == [(4, 3)] * 3
    assert torch.equal(s, q.sum(dim=1)) and torch.equal(first2, q[:, :2])
    shapes.clear()
    assert torch.equal(search_blocks(q, 0, 1024, search)[0], q.sum(dim=1)) and shapes == [(10, 3)]


@pytest.mark.parametrize("approx", [False, "guaranteed"])
def test_cut_query_blocks_give_the_same_results(monkeypatch, approx):
    from codemix_dense_retrieval_torch.parallel import sharded_search as ss

    rng = np.random.default_rng(5)
    docs = _aniso(rng, 700, 32)
    primary, secondary = _unit(rng.standard_normal((13, 32))), _unit(rng.standard_normal((13, 32)))
    _, port_ix = _indexes(docs)
    port_ix.enable_sketch(sketch_dim=8)
    want_s = port_ix.search(primary, 10, query_block=0, approx=approx, return_docids=False)
    want_f = port.sweep_index(port_ix, primary, secondary, ALPHAS, 10, approx=approx, query_block=0)
    monkeypatch.setattr(ss, "fit_query_block", lambda query_block, n, rows, device: 4)
    got_s = port_ix.search(primary, 10, query_block=0, approx=approx, return_docids=False)
    got_f = port.sweep_index(port_ix, primary, secondary, ALPHAS, 10, approx=approx, query_block=0)
    np.testing.assert_array_equal(got_s[1], want_s[1])
    np.testing.assert_array_equal(got_s[0], want_s[0])
    np.testing.assert_array_equal(got_f[1], want_f[1])
    np.testing.assert_array_equal(got_f[0], want_f[0])
