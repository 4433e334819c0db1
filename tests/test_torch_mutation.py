"""Online mutation of index/flat.py (add, remove, grow, rebalance, to_store)
and pipeline/rerank.py (two-stage add, remove, save) against the JAX package
on the same numpy inputs: the JAX index on a one-shard mesh with Pallas in
interpret mode, the port on the CPU, at <= 1,024 rows of d = 32 padded to
multiples of 128.

Equal after every step: the returned positions, ``last_swaps``, the live
docid layout, ``count``, ``mutation_epoch``, the capacity and the device rows
bit for bit (int8: codes and scales, the pad included), and the search ids;
scores within 1e-5 (the same products summed in another order). The sketch
sidecar within one bf16 ulp of its stored values and 1e-5 of its tails (the
tolerances of tests/test_torch_sketch.py: a product summed in another order
may round to the neighbouring bf16 value).
"""

import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex as PortIndex
from codemix_dense_retrieval_torch.index.flat import swap_sources
from codemix_dense_retrieval_torch.io.shards import ShardStore as PortStore
from codemix_dense_retrieval_torch.io.token_shards import TokenShardStore as PortTokens
from codemix_dense_retrieval_torch.io.token_shards import TokenShardWriter as PortWriter
from codemix_dense_retrieval_torch.ops.quant import quantize_rows_np
from codemix_dense_retrieval_torch.pipeline.rerank import TwoStageSearcher as PortTwoStage
from codemix_dense_retrieval_tpu.index.flat import DenseFlatIndex as RefIndex
from codemix_dense_retrieval_tpu.io.token_shards import TokenShardStore as RefTokens
from codemix_dense_retrieval_tpu.parallel import make_mesh
from codemix_dense_retrieval_tpu.pipeline.rerank import TwoStageSearcher as RefTwoStage

D = 32
TOL = 1e-5


def _normalize(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _rows(rng, n, d=D):
    return _normalize(rng.standard_normal((n, d)).astype(np.float32))


def _pair(docs, ids, dtype):
    ref = RefIndex.build(docs, ids, dtype=dtype)
    ref.to_device(make_mesh(shard=1, tp=1), pad_multiple=128)
    port = PortIndex.build(docs, ids, dtype=dtype).to_device("cpu", pad_multiple=128)
    return ref, port


def _dev_bits(port, ref):
    """(port rows, JAX rows) of the whole padded device tensor as comparable
    numpy bits."""
    r = np.asarray(ref._docs_dev)
    p = port._docs_dev[0]
    if p.dtype == torch.bfloat16:
        return p.view(torch.int16).numpy().view(np.uint16), r.view(np.uint16)
    return p.numpy(), r


def _bits(rows):
    """Host store rows as comparable numpy (bf16 as its uint16 bits, the
    port's storage format)."""
    rows = np.asarray(rows)
    return rows.view(np.uint16) if str(rows.dtype) == "bfloat16" else rows


def _same_sketch(port, ref):
    ps, pt = port._sketch[0][0].float().numpy(), port._sketch[1][0].numpy()
    rs, rt = np.asarray(ref._sketch[0], np.float32), np.asarray(ref._sketch[1])
    ulp = np.maximum(np.abs(rs), np.abs(ps)) * 2.0 ** -7
    assert (np.abs(ps - rs) <= ulp + 1e-7).all()
    assert (ps == rs).all(axis=1).mean() > 0.9
    np.testing.assert_allclose(pt, rt, rtol=0, atol=1e-5)


def _same(port, ref, qs, dtype, *, positions=None, want_positions=None, k=10):
    assert port.count == ref.count
    assert port.mutation_epoch == ref.mutation_epoch
    assert port._rows_per_shard == ref._rows_per_shard
    assert port.last_swaps == ref.last_swaps
    assert list(port.docids) == list(ref.docids)
    assert int(port._counts_dev[0]) == int(np.asarray(ref._counts_dev).sum())
    if positions is not None:
        np.testing.assert_array_equal(positions, want_positions)
    pb, rb = _dev_bits(port, ref)
    np.testing.assert_array_equal(pb, rb)
    if dtype == "int8":
        np.testing.assert_array_equal(port.search_kwargs["doc_scales"][0].numpy(),
                                      np.asarray(ref.search_kwargs["doc_scales"]))
    if ref._sketch is not None:
        _same_sketch(port, ref)
    rv, rd = ref.search(qs, k)
    pv, pd = port.search(qs, k)
    np.testing.assert_array_equal(pd, rd)
    np.testing.assert_allclose(pv, rv, rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_mutation_sequence_matches_jax(dtype, tmp_path):
    """add, remove (with unknown ids), re-add, an add that grows, rebalance,
    and a remove batch with a swap chain, with a sketch armed throughout."""
    rng = np.random.default_rng({"float32": 0, "bfloat16": 1, "int8": 2}[dtype])
    n = 600
    docs = _rows(rng, n)
    ids = [f"d{i}" for i in range(n)]
    qs = _rows(rng, 8)
    ref, port = _pair(docs, ids, dtype)
    ref.enable_sketch(sketch_dim=8, cache=False)
    port.enable_sketch(sketch_dim=8, cache=False)
    _same(port, ref, qs, dtype)

    # 1. an add inside the capacity (600 rows padded to 640); two of the new
    # rows lie on queries, so they rank first
    new = _rows(rng, 20)
    new[:2] = qs[:2]
    names = [f"a{i}" for i in range(20)]
    want = ref.add(new, names)
    got = port.add(new, names)
    _same(port, ref, qs, dtype, positions=got, want_positions=want)
    assert port._rows_per_shard == 640 and not port.mutation_stats["grows"]
    assert port.mutation_stats["row_of_s"] is not None
    assert port.search(qs[:2], 1)[1][:, 0].tolist() == ["a0", "a1"]

    # 2. a remove with unknown ids and a hole that is the last row
    gone = ["d5", "a3", "nope", "d599", "a19", "a0"]
    assert ref.remove(gone) == port.remove(gone) == 5
    assert port.last_swaps
    _same(port, ref, qs, dtype)
    assert "a0" not in set(port.search(qs[:1], 20)[1][0])

    # 3. re-add two removed docids (new vectors)
    back = _rows(rng, 2)
    want = ref.add(back, ["d5", "a3"])
    got = port.add(back, ["d5", "a3"])
    _same(port, ref, qs, dtype, positions=got, want_positions=want)

    # 4. an add past the capacity grows to ceil(int(1.5 * 617) + 100, 1024) rows
    more = _rows(rng, 100)
    names = [f"g{i}" for i in range(100)]
    want = ref.add(more, names)
    got = port.add(more, names)
    assert port._rows_per_shard == 2048 and port.mutation_stats["grows"][0]["to_rows"] == 2048
    _same(port, ref, qs, dtype, positions=got, want_positions=want)

    # 5. rebalance: the rows stay, the pad past them is cleared
    ref.rebalance()
    port.rebalance()
    _same(port, ref, qs, dtype)

    # 6. a swap chain: the hole at count-2 takes the last row, which the
    # hole at 3 then takes again
    c = port.count
    batch = [str(port.docids[c - 2]), str(port.docids[3]), "ghost", str(port.docids[0])]
    assert ref.remove(batch) == port.remove(batch) == 3
    dsts = [d for _, d in port.last_swaps]
    assert any(s in dsts[: i] for i, (s, _) in enumerate(port.last_swaps)), port.last_swaps
    _same(port, ref, qs, dtype)

    # save -> load round trips in both packages, to the same rows
    port.save(tmp_path / "port")
    ref.save(tmp_path / "ref")
    p2 = PortIndex.load(tmp_path / "port")
    r2 = PortStore.open(tmp_path / "ref")
    assert p2.count == port.count == r2.count
    assert list(p2.store.docids) == list(r2.docids) == [str(x) for x in port.docids[: port.count]]
    np.testing.assert_array_equal(_bits(p2.store.vectors), _bits(r2.vectors))
    if dtype == "int8":
        np.testing.assert_array_equal(p2.store.scales, r2.scales)
    p2.to_device("cpu", pad_multiple=128)
    np.testing.assert_array_equal(p2.search(qs, 10)[1], port.search(qs, 10)[1])


def test_add_and_remove_errors_change_nothing():
    rng = np.random.default_rng(3)
    docs = _rows(rng, 100)
    ids = [f"d{i}" for i in range(100)]
    ref, port = _pair(docs, ids, "float32")
    for ix in (ref, port):
        with pytest.raises(ValueError, match="duplicate docids within the batch"):
            ix.add(_rows(rng, 2), ["x", "x"])
        with pytest.raises(ValueError, match="docids already present"):
            ix.add(_rows(rng, 2), ["y", "d7"])
        with pytest.raises(ValueError, match="row dim 16 != index dim 32"):
            ix.add(_rows(rng, 1, 16), ["z"])
        with pytest.raises(ValueError, match="2 rows vs 1 docids"):
            ix.add(_rows(rng, 2), ["z"])
        assert ix.count == 100 and ix.mutation_epoch == 0
        assert ix.remove(["nope"]) == 0 and ix.mutation_epoch == 0
    assert port.add(docs[0], ["single"]).tolist() == ref.add(docs[0], ["single"]).tolist() == [100]


@pytest.mark.parametrize("seed", [0, 1])
def test_swap_sources_replays_the_journal(seed):
    """One gather from the resolved sources equals the moves one by one."""
    rng = np.random.default_rng(seed)
    rows = np.arange(50)
    live, swaps = rows.copy(), []
    count = 50
    for pos in rng.permutation(40)[:15]:
        hit = np.flatnonzero(live[:count] == pos)
        if not len(hit):
            continue
        p, last = int(hit[0]), count - 1
        if p != last:
            live[p] = live[last]
            swaps.append((last, p))
        count -= 1
    dst = np.fromiter(dict.fromkeys(d for _, d in swaps), np.int64)
    replay = rows.copy()
    replay[dst] = rows[swap_sources(swaps, dst)]
    keep = dst[dst < count]
    np.testing.assert_array_equal(replay[keep], live[keep])


def test_int8_quantize_of_dequantize_is_exact():
    """What an int8 row's move relies on (the JAX package re-quantizes the
    dequantized row): the quantizer's codes and scales come back bit for bit,
    for zero rows, one-hot rows and scales over many binades."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((20_000, D)).astype(np.float32)
    x *= (2.0 ** rng.integers(-40, 40, len(x))).astype(np.float32)[:, None]
    x[:5] = 0.0
    x[5:10] = np.eye(D, dtype=np.float32)[:5] * 3.7
    q, s = quantize_rows_np(x)
    q2, s2 = quantize_rows_np(q.astype(np.float32) * s[:, None])
    np.testing.assert_array_equal(q2, q)
    np.testing.assert_array_equal(s2, s)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_reorder_sketch_and_save_read_the_live_rows(dtype, tmp_path):
    """After a mutation, reorder_rows, enable_sketch and save start from the
    live rows: each equals the same step on a fresh index over to_store()'s
    rows, and reorder_rows leaves mutation behind."""
    rng = np.random.default_rng(5)
    docs = _rows(rng, 700)
    ids = [f"d{i}" for i in range(700)]
    ref, port = _pair(docs, ids, dtype)
    extra = _rows(rng, 30)
    for ix in (ref, port):
        ix.add(extra, [f"n{i}" for i in range(30)])
        ix.remove(["d1", "d2", "n4"])
    live = ref.to_store()
    fresh = PortIndex(PortStore.build(
        np.asarray(live.vectors, np.float32) if dtype != "int8" else live.vectors, live.docids,
        dtype=dtype, scales=live.scales,
    )).to_device("cpu", pad_multiple=128)
    # enable_sketch fits on the live rows
    port.enable_sketch(sketch_dim=8, cache=False)
    fresh.enable_sketch(sketch_dim=8, cache=False)
    np.testing.assert_array_equal(port._sketch[2].numpy(), fresh._sketch[2].numpy())
    n = port.count
    assert torch.equal(port._sketch[0][0][:n], fresh._sketch[0][0][:n])
    # save writes the live rows
    port.save(tmp_path / "ix")
    saved = PortStore.open(tmp_path / "ix")
    assert list(saved.docids) == list(live.docids)
    np.testing.assert_array_equal(_bits(saved.vectors), _bits(live.vectors))
    # reorder_rows: the JAX package's permutation of the live rows
    want = ref.reorder_rows(sketch_dim=8, sample=2048)
    perm = port.reorder_rows(sketch_dim=8, sample=2048)
    np.testing.assert_array_equal(perm, want)
    assert port._mutable is None and port.last_swaps == [] and port.count == n
    assert list(port.store.docids) == [live.docids[i] for i in perm]
    np.testing.assert_array_equal(_bits(port.store.vectors), _bits(live.vectors)[perm])
    qs = _rows(rng, 6)
    np.testing.assert_array_equal(port.search(qs, 10)[1], ref.search(qs, 10)[1])
    # and mutates again from the new store
    port.add(_rows(rng, 1), ["after"])
    assert port.count == n + 1 and port.docids[n] == "after"


def test_sketch_cache_checks_the_live_count(tmp_path):
    rng = np.random.default_rng(6)
    PortIndex.build(_rows(rng, 300), [f"d{i}" for i in range(300)]).save(tmp_path / "ix")
    ix = PortIndex.load(tmp_path / "ix").to_device("cpu", pad_multiple=128)
    ix.enable_sketch(sketch_dim=8)
    ix.add(_rows(rng, 5), [f"n{i}" for i in range(5)])
    assert int(np.load(tmp_path / "ix" / "sketch.npz")["count"]) == 300
    ix.enable_sketch(sketch_dim=8)  # the cache's count no longer matches: refit over the live rows
    assert int(np.load(tmp_path / "ix" / "sketch.npz")["count"]) == 305


# ---------------------------------------------------------------- two-stage

def _tok_corpus(rng, n, t, d=D):
    toks = rng.standard_normal((n, t, d)).astype(np.float32)
    toks /= np.linalg.norm(toks, axis=-1, keepdims=True)
    dense = _normalize(toks.sum(axis=1))
    return toks, dense


def _two_stage_pair(tmp_path, n=96, td=4):
    rng = np.random.default_rng(7)
    toks, dense = _tok_corpus(rng, n, td)
    lens = rng.integers(1, td + 1, n).astype(np.int32)
    w = PortWriter(tmp_path / "tok", token_dim=D, tokens_per_doc=td, dtype="int8")
    w.append(toks, lens, [f"d{i}" for i in range(n)])
    w.finalize()
    ids = [f"d{i}" for i in range(n)]
    ref_ix, port_ix = _pair(dense, ids, "float32")
    ref = RefTwoStage(ref_ix, RefTokens.open(tmp_path / "tok"), device_resident=True)
    port = PortTwoStage(port_ix, PortTokens.open(tmp_path / "tok"), device_resident=True)
    return rng, ref, port


def _same_tokens(port, ref):
    np.testing.assert_array_equal(port._tok_dev.numpy(), np.asarray(ref._tok_dev))
    np.testing.assert_array_equal(port._scales_dev.numpy(), np.asarray(ref._scales_dev))
    np.testing.assert_array_equal(port._lengths_dev.numpy(), np.asarray(ref._lengths_dev))
    assert port.count == ref.count and port._index_epoch == ref._index_epoch


def test_two_stage_add_remove_save_match_jax(tmp_path):
    rng, ref, port = _two_stage_pair(tmp_path)
    td = 4
    # an add with token blocks longer than the store's (cut to Td) and
    # lengths past the block (clamped)
    toks, dense = _tok_corpus(rng, 7, 6)
    lens = np.array([6, 2, 4, 1, 5, 3, 6], np.int32)
    names = [f"n{i}" for i in range(7)]
    want = ref.add(dense, names, toks, lens)
    got = port.add(dense, names, torch.from_numpy(toks), lens)
    np.testing.assert_array_equal(got, want)
    _same_tokens(port, ref)
    # a remove whose swaps chain: the hole at 101 takes row 102, which the
    # hole at 3 then takes
    c = port.count
    batch = [str(port.index.docids[c - 2]), str(port.index.docids[3]), "ghost", "d0"]
    assert ref.remove(batch) == port.remove(batch) == 3
    assert port.index.last_swaps == ref.index.last_swaps
    assert port.index.last_swaps[1] == (c - 2, 3)
    _same_tokens(port, ref)
    # search: the same ids over the live corpus
    qt, qd = _tok_corpus(rng, 4, td)
    ql = np.full(4, td)
    rs, rd = ref.search(qd, qt, ql, 5, k_dense=24)
    ps, pd = port.search(qd, qt, ql, 5, k_dense=24)
    np.testing.assert_array_equal(pd, rd)
    np.testing.assert_allclose(ps, rs, rtol=0, atol=TOL)
    # save: the same dense store and token store
    ref.save(tmp_path / "ref_snap")
    port.save(tmp_path / "port_snap")
    rt, pt = RefTokens.open(tmp_path / "ref_snap" / "tokens"), PortTokens.open(tmp_path / "port_snap" / "tokens")
    assert pt.docids == rt.docids == [str(x) for x in port.index.docids[: port.count]]
    np.testing.assert_array_equal(pt.lengths, rt.lengths)
    rows = np.arange(pt.count)
    for a, b in zip(pt.gather_quantized(rows), rt.gather_quantized(rows)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(PortStore.open(tmp_path / "port_snap").vectors),
                                  np.asarray(PortStore.open(tmp_path / "ref_snap").vectors))
    # the snapshot serves as a fresh two-stage corpus
    again = PortTwoStage(PortIndex.load(tmp_path / "port_snap").to_device("cpu"), pt)
    np.testing.assert_array_equal(again.search(qd, qt, ql, 5, k_dense=24)[1], pd)


def test_two_stage_refusals(tmp_path):
    rng, ref, port = _two_stage_pair(tmp_path)
    # an add past the spare capacity (96 rows in 128) changes nothing
    toks, dense = _tok_corpus(rng, 40, 4)
    for s in (ref, port):
        with pytest.raises(ValueError, match="would regrow the dense index"):
            s.add(dense, [f"x{i}" for i in range(40)], toks, np.full(40, 4))
        assert s.count == 96 and s.index.mutation_epoch == 0
    # the memmap store is read-only
    mm = PortTwoStage(port.index, PortTokens.open(tmp_path / "tok"), device_resident=False)
    with pytest.raises(ValueError, match="device-resident"):
        mm.add(dense[:1], ["x"], toks[:1], [4])
    # a searcher refuses an index mutated before it was built, even when
    # its count is back where it was
    for ix in (port.index, ref.index):
        ix.add(dense[:1], ["y"])
        ix.remove(["y"])
    with pytest.raises(ValueError, match="was mutated"):
        PortTwoStage(port.index, PortTokens.open(tmp_path / "tok"))
    with pytest.raises(ValueError, match="was mutated"):
        RefTwoStage(ref.index, RefTokens.open(tmp_path / "tok"))
