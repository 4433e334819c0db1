"""parallel/sharded_search.py over S shards: the port against the JAX package
on its 8 forced CPU devices (Pallas in interpret mode), the port's shards
on the CPU (``make_mesh(S, devices=["cpu"] * S)``), the same numpy inputs.

Equal: the shard layout (rows per shard, per-shard counts, each shard's
rows bit for bit) for S in {1, 4, 8}, and the ids of the exact (every
method), int8, sketch and adaptive searches over 8 shards; the sketch
tier's certificates and the adaptive tier's stats. Values within 1e-5 (on
the CPU torch's matmul and XLA's dot sum a row's products in another
order); int8 values within 2^-22 relative (exact integer products, the
rescale's f32 products rounded once more or less), as in
tests/test_torch_int8.py. Where the sketch tier is compared, both packages get the JAX
package's sketch sidecar, split per shard for the port, as
tests/test_torch_sketch.py does.

Also here: every ctypes kernel launch runs under its operands' CUDA device.
"""

import ast
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.io.shards import ShardStore as PortStore
from codemix_dense_retrieval_torch.ops import kernels
from codemix_dense_retrieval_torch.ops import topk as port_topk
from codemix_dense_retrieval_torch.parallel import sharded_search as port
from codemix_dense_retrieval_torch.parallel.mesh import make_mesh as port_mesh
from codemix_dense_retrieval_tpu.ops import sketch as ref_sketch
from codemix_dense_retrieval_tpu.parallel import sharded_search as ref
from codemix_dense_retrieval_tpu.parallel.mesh import make_mesh as ref_mesh

TOL = 1e-5
PORT_OPS = pathlib.Path(__file__).resolve().parents[1] / "codemix_dense_retrieval_torch" / "ops"


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _meshes(devs, s):
    return ref_mesh(shard=s, tp=1, devices=devs[:s]), port_mesh(shard=s, devices=["cpu"] * s)


def _split(arr, s):
    """A JAX row-sharded global array as the port's per-shard tensors."""
    a = np.asarray(arr)
    if a.dtype == jnp.bfloat16:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return list(t.split(t.shape[0] // s))


def _counts(counts):
    return [torch.tensor([int(c)], dtype=torch.int32) for c in np.asarray(counts)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("s", [1, 4, 8])
def test_shard_rows_layout_matches_jax(eight_cpu_devices, s, dtype):
    rng = np.random.default_rng(s)
    n = 1000 + 37 * s
    store = PortStore.build(_unit(rng, n, 16), [f"d{i}" for i in range(n)], dtype=dtype)
    rmesh, pmesh = _meshes(eight_cpu_devices, s)
    rrows, rcounts, rrps = ref.shard_rows(np.asarray(store.vectors), rmesh, pad_multiple=128)
    prows, pcounts, prps = port.shard_rows(store, pmesh, pad_multiple=128)
    assert prps == rrps and len(prows) == len(pcounts) == s
    assert [int(c[0]) for c in pcounts] == np.asarray(rcounts).tolist()
    want = _split(rrows, s) if dtype != "bfloat16" else _split(jnp.asarray(np.asarray(store.vectors)), 1)
    if dtype == "bfloat16":  # the JAX rows are the store's uint16 bits, padded
        flat = torch.cat([r.view(torch.int16) for r in prows]).numpy()
        np.testing.assert_array_equal(flat, np.asarray(rrows).view(np.int16))
    else:
        for got, ref_rows in zip(prows, want):
            np.testing.assert_array_equal(got.numpy(), ref_rows.numpy())
    if dtype == "int8":
        rsc = ref.shard_row_sidecar(store.scales, rmesh, rrps)
        psc = port.shard_row_sidecar(store.scales, pmesh, prps)
        np.testing.assert_array_equal(torch.cat(psc).numpy(), np.asarray(rsc))


@pytest.mark.parametrize("method,k", [("auto", 25), ("full", 64), ("bins_xla", 17), ("bins_pallas", 100),
                                      ("bins_two_level", 40)])
def test_exact_search_over_8_shards_matches_jax(eight_cpu_devices, method, k):
    rng = np.random.default_rng(11)
    n, d = 3000, 32
    docs, qs = _unit(rng, n, d), _unit(rng, 12, d)
    rmesh, _ = _meshes(eight_cpu_devices, 8)
    rdocs, rcounts, rps = ref.shard_rows(docs, rmesh, pad_multiple=128)
    kw = dict(method=method, tile_n=128)
    rv, ri = ref.sharded_topk_ip(jnp.asarray(qs), rdocs, rcounts, k, mesh=rmesh, interpret=True, **kw)
    pv, pi = port.sharded_topk_ip(torch.from_numpy(qs), _split(rdocs, 8), _counts(rcounts), k, **kw)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=0, atol=TOL)
    # global padded ids of valid rows are the row ids
    want = np.argsort(-(qs @ docs.T), axis=1, kind="stable")[:, :k]
    assert (pi.numpy() == want).mean() > 0.99


def test_merge_breaks_ties_by_global_id_across_shards():
    """The same vector in shards 0, 3 and 7: the merge puts the lower
    global id first (the JAX suite's tie-break case)."""
    rng = np.random.default_rng(3)
    d, k = 16, 6
    v = _unit(rng, 1, d)[0]
    docs = rng.standard_normal((2048, d)).astype(np.float32) * 0.01
    for row in (10, 3 * 256 + 5, 7 * 256 + 99):
        docs[row] = v
    store = PortStore.build(docs, [str(i) for i in range(2048)], dtype="float32")
    rows, counts, rps = port.shard_rows(store, port_mesh(shard=8, devices=["cpu"] * 8), pad_multiple=256)
    assert rps == 256
    _, gids = port.sharded_topk_ip(torch.from_numpy(v[None]), rows, counts, k, method="bins_xla", bin_size=64)
    assert gids[0, :3].tolist() == [10, 3 * 256 + 5, 7 * 256 + 99]


@pytest.mark.parametrize("method", ["auto", "bins_xla", "bins_two_level"])
def test_int8_search_over_8_shards_matches_jax(eight_cpu_devices, method):
    rng = np.random.default_rng(12)
    n, d, k = 2500, 64, 30
    qs = _unit(rng, 10, d)
    store = PortStore.build(_unit(rng, n, d), [str(i) for i in range(n)], dtype="int8")
    rmesh, pmesh = _meshes(eight_cpu_devices, 8)
    rrows, rcounts, rrps = ref.shard_rows(np.asarray(store.vectors), rmesh, pad_multiple=128)
    rsc = ref.shard_row_sidecar(store.scales, rmesh, rrps)
    prows, pcounts, prps = port.shard_rows(store, pmesh, pad_multiple=128)
    psc = port.shard_row_sidecar(store.scales, pmesh, prps)
    rv, ri = ref.sharded_topk_ip(jnp.asarray(qs), rrows, rcounts, k, mesh=rmesh, method=method,
                                 doc_scales=rsc, tile_n=128, interpret=True)
    pv, pi = port.sharded_topk_ip(torch.from_numpy(qs), prows, pcounts, k, method=method,
                                  doc_scales=psc, tile_n=128)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=2.0 ** -22, atol=0)


def _aniso(rng, n, d, decay=0.08):
    x = rng.standard_normal((n, d)).astype(np.float32) * np.exp(-decay * np.arange(d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("probe", [4, 16])
def test_sketch_search_over_8_shards_matches_jax(eight_cpu_devices, probe):
    rng = np.random.default_rng(13)
    n, d, k = 3000, 64, 10
    docs, qs = _aniso(rng, n, d), _aniso(rng, 16, d)
    rmesh, _ = _meshes(eight_cpu_devices, 8)
    rdocs, rcounts, rps = ref.shard_rows(docs.astype(jnp.bfloat16), rmesh, pad_multiple=128)
    proj = ref_sketch.fit_sketch(docs, 24)
    sk, tails = jax.jit(ref_sketch.sketch_rows)(rdocs, jnp.asarray(proj))
    kw = dict(probe_bins=probe, bin_size=8, super_size=4, tile_n=128)
    rv, ri, rc = ref.sharded_topk_ip_sketch(jnp.asarray(qs), rdocs, rcounts, sk, tails, jnp.asarray(proj), k,
                                            mesh=rmesh, interpret=True, **kw)
    pv, pi, pc = port.sharded_topk_ip_sketch(
        torch.from_numpy(qs), _split(rdocs, 8), _counts(rcounts), _split(sk, 8), _split(tails, 8),
        torch.from_numpy(proj), k, **kw)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=0, atol=TOL)
    # a certified query is the exact search's
    ev, ei = port.sharded_topk_ip(torch.from_numpy(qs).to(torch.bfloat16), _split(rdocs, 8), _counts(rcounts), k)
    cert = pc.numpy()
    np.testing.assert_array_equal(pi.numpy()[cert], ei.numpy()[cert])


def _planted(rng, n, d, b, k, frac_easy):
    """The JAX suite's adaptive corpus: a planted, contiguous,
    well-separated top block for ``frac_easy`` of the queries, uniform rows
    for the rest."""
    docs = _unit(rng, n, d) * 0.1
    qs = _unit(rng, b, d)
    for i in range(int(b * frac_easy)):
        dirs = qs[i] + 0.05 * rng.standard_normal((2 * k, d)).astype(np.float32)
        docs[i * 2 * k : (i + 1) * 2 * k] = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    return docs, qs


@pytest.mark.parametrize("frac_easy,probe,branch", [(1.0, 10, "none"), (0.75, 10, "tail"), (0.0, 5, "exact")])
def test_adaptive_search_over_8_shards_matches_jax_and_exact(eight_cpu_devices, frac_easy, probe, branch):
    """All certified, the tail escalation (<= B/2 escalated) and the exact
    escalation (> B/2): ids and stats equal to the JAX package's, results
    equal to the port's exact search."""
    rng = np.random.default_rng(14)
    n, d, b, k = 8192, 48, 16, 40
    docs, qs = _planted(rng, n, d, b, k, frac_easy)
    rmesh, _ = _meshes(eight_cpu_devices, 8)
    rdocs, rcounts, _ = ref.shard_rows(docs, rmesh, pad_multiple=256)
    rv, rg, rstats = ref.sharded_topk_ip_adaptive(jnp.asarray(qs), rdocs, rcounts, k, mesh=rmesh,
                                                  probe_bins=probe, tile_n=256, tile_b=64, interpret=True)
    shards, counts = _split(rdocs, 8), _counts(rcounts)
    pv, pg, pstats = port.sharded_topk_ip_adaptive(torch.from_numpy(qs), shards, counts, k,
                                                   probe_bins=probe, tile_n=256)
    assert pstats == rstats
    escalated = pstats.get("escalated", 0)
    assert {"none": escalated == 0, "tail": 0 < escalated <= b // 2, "exact": escalated > b // 2}[branch]
    np.testing.assert_array_equal(pg.numpy(), np.asarray(rg))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=0, atol=TOL)
    ev, eg = port.sharded_topk_ip(torch.from_numpy(qs), shards, counts, k, tile_n=256)
    np.testing.assert_array_equal(pg.numpy(), eg.numpy())
    np.testing.assert_array_equal(pv.numpy(), ev.numpy())


def test_fit_query_block_counts_the_shards_that_share_a_card(monkeypatch):
    """Four shards on one card leave each a quarter of its free memory: the
    block is cut to the largest power of two that fits all four."""
    free = 20e9
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (int(free), int(free)))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 0)
    card = torch.device("cuda", 0)
    rps = 2_211_840
    one = port.fit_query_block(1024, 4096, rps, card)
    four = port.fit_query_block(1024, 4096, rps, [card] * 4)
    fit1 = int(port.BLOCK_MEMORY_SHARE * free // (port_topk.BLOCK_BYTES_PER_ROW * rps))
    fit4 = int(port.BLOCK_MEMORY_SHARE * free // (port_topk.BLOCK_BYTES_PER_ROW * rps * 4))
    assert one == (1024 if fit1 >= 1024 else 1 << (fit1.bit_length() - 1))
    assert four == 1 << (fit4.bit_length() - 1) and four < one
    assert port.fit_query_block(1024, 4096, rps, [torch.device("cpu")] * 4) == 1024


def test_the_route_is_decided_in_topk_alone():
    """``sharded_search.py`` names no private ``topk`` name and decides no
    method, bin size or queries per launch: one shard's route is
    ``topk.shard_topk``'s (and the sketch tier's ``sketch.shard_topk_sketch``'s)."""
    path = pathlib.Path(port.__file__)
    tree = ast.parse(path.read_text(), filename=str(path))
    private = sorted({
        node.attr for node in ast.walk(tree)
        if isinstance(node, ast.Attribute) and getattr(node.value, "id", "") == "topk_ops"
        and node.attr.startswith("_")
    })
    assert private == []
    compared = {
        node.left.id for node in ast.walk(tree)
        if isinstance(node, ast.Compare) and isinstance(node.left, ast.Name)
    }
    assert not compared & {"method", "tile_b", "bin_size"}
    assert not hasattr(port, "BLOCK_BYTES_PER_ROW") and not hasattr(port, "METHODS")


# ---------------------------------------------------------------- device guard


def test_launch_runs_under_the_operands_device(monkeypatch):
    """A fake library records the current device at each launch:
    ``kernels.launch`` makes the operands' card current around the call,
    restores the previous one after it, and passes that card's current
    stream last."""
    state = {"current": torch.device("cuda", 0)}

    class FakeDeviceGuard:
        def __init__(self, device):
            self.device, self.prev = torch.device(device), None

        def __enter__(self):
            self.prev, state["current"] = state["current"], self.device

        def __exit__(self, *exc):
            state["current"] = self.prev

    streams = {}
    monkeypatch.setattr(torch.cuda, "device", FakeDeviceGuard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: streams.setdefault(dev, types.SimpleNamespace(cuda_stream=100 + dev.index)))
    calls = []

    def fake_entry(*args):
        calls.append((state["current"], args))
        return 0

    for card in (1, 3, 0):
        assert kernels.launch(fake_entry, torch.device("cuda", card), 7, 8) == 0
    assert calls == [(torch.device("cuda", c), (7, 8, 100 + c)) for c in (1, 3, 0)]
    assert state["current"] == torch.device("cuda", 0)


def _launch_calls():
    """(file, line, device argument) of every ``kernels.launch`` call in the
    port's ops modules, and every other call of a loaded entry point."""
    found, direct = [], []
    for path in sorted(PORT_OPS.glob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "launch" and getattr(f.value, "id", "") == "kernels":
                found.append((path.name, node.lineno, ast.unparse(node.args[1])))
            elif isinstance(f, ast.Call) and isinstance(f.func, ast.Name) and f.func.id.endswith("_lib"):
                direct.append((path.name, node.lineno))
    return found, direct


def test_every_ctypes_launch_site_goes_through_the_guard():
    """The sixteen launch sites (kernels A / 2, 4, 5, 7, 6, B, the f32
    queries' tf32 split, cover_rescore, super_select, Kimi Delta
    Attention's scan, convolution, gates and output norm, and an expert
    share's row gather, activation and combine) call their entry points
    only through ``kernels.launch``, with an operand's device; no other
    module reads a stream handle."""
    found, direct = _launch_calls()
    assert direct == []
    assert sorted(name for name, _, _ in found) == [
        "flash_attention.py", "grouped_mm.py", "grouped_mm.py", "grouped_mm.py", "kda.py", "kda.py", "kda.py",
        "kda.py", "maxsim.py", "sketch.py", "topk.py", "topk.py", "topk.py", "topk.py", "topk.py", "topk.py"]
    assert {dev for _, _, dev in found} <= {
        "docs.device", "dev", "q.device", "d_sketch.device", "x.device", "bin_max.device", "f.device",
        "o.device", "gu.device", "ys.device"}
    for path in PORT_OPS.parent.rglob("*.py"):
        if path.name != "kernels.py":
            assert "cuda_stream" not in path.read_text(), path
