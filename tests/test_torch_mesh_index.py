"""index/flat.py over 8 shards: online mutation (add, remove, grow,
rebalance, to_store / save) and reorder_rows against the JAX package's
index on its 8 forced CPU devices (Pallas in interpret mode), the port's 8
shards on the CPU, at <= 1,500 rows of d = 32 padded to multiples of 128.

Equal after every step: the returned positions (adds go to the emptiest
shard, ties to the lowest), ``last_swaps``, the live docid layout over the
global padded positions, ``count``, the per-shard counts, ``mutation_epoch``,
the rows per shard and the device rows of every shard bit for bit (int8:
codes and scales, the pad included), and the search ids; scores within
1e-5 (the same products summed in another order). The sketch sidecar within
one bf16 ulp of its stored values and 1e-5 of its tails, the tolerances of
tests/test_torch_mutation.py (the one-shard case of the same sequence).
"""

import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex as PortIndex
from codemix_dense_retrieval_torch.io.shards import ShardStore as PortStore
from codemix_dense_retrieval_torch.parallel.mesh import make_mesh as port_mesh
from codemix_dense_retrieval_tpu.index.flat import DenseFlatIndex as RefIndex
from codemix_dense_retrieval_tpu.parallel.mesh import make_mesh as ref_mesh

D = 32
S = 8
TOL = 1e-5


def _rows(rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _pair(devs, docs, ids, dtype):
    ref = RefIndex.build(docs, ids, dtype=dtype)
    ref.to_device(ref_mesh(shard=S, tp=1, devices=devs), pad_multiple=128)
    port = PortIndex.build(docs, ids, dtype=dtype).to_device(port_mesh(shard=S, devices=["cpu"] * S),
                                                             pad_multiple=128)
    return ref, port


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _same(port, ref, qs, dtype, *, positions=None, want_positions=None, k=10):
    assert port.count == ref.count
    assert port.mutation_epoch == ref.mutation_epoch
    assert port._rows_per_shard == ref._rows_per_shard
    assert port.last_swaps == ref.last_swaps
    assert list(port.docids) == list(ref.docids)
    assert [int(c[0]) for c in port._counts_dev] == np.asarray(ref._counts_dev).tolist()
    if ref._mutable is not None:
        assert port._mutable["counts"].tolist() == ref._mutable["counts"].tolist()
        assert port._mutable["row_of"] == ref._mutable["row_of"]
    if positions is not None:
        np.testing.assert_array_equal(positions, want_positions)
    assert len(port._docs_dev) == S
    got = np.concatenate([_bits(t) for t in port._docs_dev])
    want = np.asarray(ref._docs_dev)
    np.testing.assert_array_equal(got, want.view(np.int16) if dtype == "bfloat16" else want)
    if dtype == "int8":
        np.testing.assert_array_equal(torch.cat(port.search_kwargs["doc_scales"]).numpy(),
                                      np.asarray(ref.search_kwargs["doc_scales"]))
    if ref._sketch is not None:
        ps = torch.cat(port._sketch[0]).float().numpy()
        pt = torch.cat(port._sketch[1]).numpy()
        rs, rt = np.asarray(ref._sketch[0], np.float32), np.asarray(ref._sketch[1])
        ulp = np.maximum(np.abs(rs), np.abs(ps)) * 2.0 ** -7
        assert (np.abs(ps - rs) <= ulp + 1e-7).all()
        np.testing.assert_allclose(pt, rt, rtol=0, atol=1e-5)
    rv, rd = ref.search(qs, k)
    pv, pd = port.search(qs, k)
    np.testing.assert_array_equal(pd, rd)
    np.testing.assert_allclose(pv, rv, rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_mutation_sequence_on_8_shards_matches_jax(eight_cpu_devices, dtype, tmp_path):
    """add (emptiest shard first), remove with unknown ids and a shard's
    last row, re-add, an add that grows every shard, a skewed remove,
    rebalance, a remove batch with a swap chain inside one shard, and
    save, with a sketch armed throughout."""
    rng = np.random.default_rng({"float32": 0, "bfloat16": 1, "int8": 2}[dtype])
    n = 600  # 75 rows per shard, padded to 128: 1,024 rows of capacity
    docs = _rows(rng, n)
    ids = [f"d{i}" for i in range(n)]
    qs = _rows(rng, 8)
    ref, port = _pair(eight_cpu_devices, docs, ids, dtype)
    assert port._rows_per_shard == 128 and [int(c[0]) for c in port._counts_dev] == [128] * 4 + [88] + [0] * 3
    ref.enable_sketch(sketch_dim=8, cache=False)
    port.enable_sketch(sketch_dim=8, cache=False)
    _same(port, ref, qs, dtype)

    # 1. an add inside the capacity fills the empty shards first; two rows
    # lie on queries, so they rank first
    new = _rows(rng, 20)
    new[:2] = qs[:2]
    names = [f"a{i}" for i in range(20)]
    want = ref.add(new, names)
    got = port.add(new, names)
    _same(port, ref, qs, dtype, positions=got, want_positions=want)
    assert sorted(set(got // 128)) == [5, 6, 7] and not port.mutation_stats["grows"]
    assert port.search(qs[:2], 1)[1][:, 0].tolist() == ["a0", "a1"]

    # 2. a remove with unknown ids, holes in several shards and one that is
    # its shard's last row
    last_of_0 = str(port.docids[127])
    gone = ["d5", "a3", "nope", last_of_0, "d300", "a19", "a0"]
    assert ref.remove(gone) == port.remove(gone) == 6
    assert port.last_swaps
    _same(port, ref, qs, dtype)

    # 3. re-add two removed docids (new vectors)
    back = _rows(rng, 2)
    want = ref.add(back, ["d5", "a3"])
    got = port.add(back, ["d5", "a3"])
    _same(port, ref, qs, dtype, positions=got, want_positions=want)

    # 4. an add past the capacity grows every shard to
    # ceil_to(ceil((int(1.5 * 616) + 500) / 8), 1024) rows, each keeping its rows
    more = _rows(rng, 500)
    names = [f"g{i}" for i in range(500)]
    want = ref.add(more, names)
    got = port.add(more, names)
    assert port._rows_per_shard == 1024 and port.mutation_stats["grows"][0]["to_rows"] == 1024
    _same(port, ref, qs, dtype, positions=got, want_positions=want)

    # 5. a skewed remove (most of shard 0), then rebalance: per = ceil(n / 8)
    skew = [str(x) for x in port.docids[: 100]]
    assert ref.remove(skew) == port.remove(skew) == 100
    _same(port, ref, qs, dtype)
    ref.rebalance()
    port.rebalance()
    per = -(-port.count // S)
    assert port._mutable["counts"].tolist() == [per] * (S - 1) + [port.count - per * (S - 1)]
    _same(port, ref, qs, dtype)

    # 6. a swap chain in one shard: the hole at the shard's count-2 takes its
    # last row, which the hole at its row 3 then takes again
    c1 = int(port._mutable["counts"][1])
    base = port._rows_per_shard
    batch = [str(port.docids[base + c1 - 2]), str(port.docids[base + 3]), "ghost", str(port.docids[0])]
    assert ref.remove(batch) == port.remove(batch) == 3
    dsts = [d for _, d in port.last_swaps]
    assert any(s in dsts[: i] for i, (s, _) in enumerate(port.last_swaps)), port.last_swaps
    _same(port, ref, qs, dtype)

    # to_store and save: shards in order, the same rows in both packages
    port.save(tmp_path / "port")
    ref.save(tmp_path / "ref")
    p2 = PortIndex.load(tmp_path / "port")
    r2 = PortStore.open(tmp_path / "ref")
    assert list(p2.store.docids) == list(r2.docids) and p2.count == port.count
    a, b = np.asarray(p2.store.vectors), np.asarray(r2.vectors)
    np.testing.assert_array_equal(a.view(np.uint16) if a.dtype.itemsize == 2 else a,
                                  b.view(np.uint16) if b.dtype.itemsize == 2 else b)
    if dtype == "int8":
        np.testing.assert_array_equal(p2.store.scales, r2.scales)
    p2.to_device(port_mesh(shard=S, devices=["cpu"] * S), pad_multiple=128)
    np.testing.assert_array_equal(p2.search(qs, 10)[1], port.search(qs, 10)[1])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_reorder_rows_on_8_shards_matches_jax(eight_cpu_devices, dtype):
    """reorder_rows of a mutated 8-shard index: the JAX package's
    permutation of the live rows (shards in order), the same new layout and
    the same search ids; mutation is left behind."""
    rng = np.random.default_rng(7)
    docs = _rows(rng, 1200)
    ids = [f"d{i}" for i in range(1200)]
    qs = _rows(rng, 6)
    ref, port = _pair(eight_cpu_devices, docs, ids, dtype)
    extra = _rows(rng, 40)
    for ix in (ref, port):
        ix.add(extra, [f"n{i}" for i in range(40)])
        ix.remove(["d1", "d200", "n4", "d1199"])
    want = ref.reorder_rows(sketch_dim=8, sample=4096)
    got = port.reorder_rows(sketch_dim=8, sample=4096)
    np.testing.assert_array_equal(got, want)
    assert port._mutable is None and port.mutation_epoch == ref.mutation_epoch
    assert list(port.docids) == list(ref.docids) and port.count == ref.count
    a, b = np.asarray(port.store.vectors), np.asarray(ref.store.vectors)
    np.testing.assert_array_equal(a.view(np.uint16) if a.dtype.itemsize == 2 else a,
                                  b.view(np.uint16) if b.dtype.itemsize == 2 else b)
    # the port re-uploads at its pad multiple, the JAX package at 1024:
    # the layouts differ, the results do not
    rv, rd = ref.search(qs, 10)
    pv, pd = port.search(qs, 10)
    np.testing.assert_array_equal(pd, rd)
    np.testing.assert_allclose(pv, rv, rtol=0, atol=TOL)


def test_rebalance_of_an_even_index_keeps_every_shard_in_place(eight_cpu_devices):
    """A rebalance that moves no row copies no shard: each shard's tensor is
    the one it was."""
    rng = np.random.default_rng(8)
    docs = _rows(rng, 1024)
    _, port = _pair(eight_cpu_devices, docs, [f"d{i}" for i in range(1024)], "float32")
    before = list(port._docs_dev)
    port.rebalance()
    assert all(a is b for a, b in zip(port._docs_dev, before))
    assert port.mutation_epoch == 1 and port._mutable["counts"].tolist() == [128] * S
