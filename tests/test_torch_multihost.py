"""parallel/multihost.py: the single-process no-op cases of the JAX suite's
tests/test_multihost.py, and a real two-process ``torch.distributed``
world (gloo on the CPU, spawned from this file: run as a script it is the
worker), two CPU shards per process, so the global mesh has four.

Each rank uploads only its own rows through ``shard_rows_multihost``
(``rows_fn`` asserts the process-local window), runs the exact search
(whose merge all-gathers the (B, k) candidates across the process
boundary), the sketch tier (certificates AND-combined across processes)
and the adaptive tier, and holds them against a numpy oracle with FAISS
tie-breaking: ids equal, values within 1e-5. It also records every
cross-process all-gather: none moves more than the (B, k) payload.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_initialize_noop_without_env(monkeypatch):
    from codemix_dense_retrieval_torch.parallel.multihost import initialize_multihost

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost() is False


def test_initialize_noop_single_process(monkeypatch):
    from codemix_dense_retrieval_torch.parallel.multihost import initialize_multihost

    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert initialize_multihost() is False


def test_process_local_rows_single_process():
    from codemix_dense_retrieval_torch.parallel.mesh import make_mesh
    from codemix_dense_retrieval_torch.parallel.multihost import process_local_rows

    # single process owns all devices -> rows start at 0
    r = process_local_rows(n_total=1000, rows_per_shard=128, mesh=make_mesh(8, devices=["cpu"] * 8))
    assert r.start == 0 and r.stop == 1000 and len(r) > 0
    r = process_local_rows(n_total=1000, rows_per_shard=128)  # the default mesh: this process's device
    assert r.start == 0 and r.stop <= 1000 and len(r) > 0


def test_shard_rows_multihost_single_process_and_the_window_check(monkeypatch):
    from codemix_dense_retrieval_torch.io.shards import ShardStore
    from codemix_dense_retrieval_torch.parallel import multihost
    from codemix_dense_retrieval_torch.parallel.mesh import make_mesh
    from codemix_dense_retrieval_torch.parallel.sharded_search import shard_rows

    rng = np.random.default_rng(1)
    docs = rng.standard_normal((700, 16)).astype(np.float32)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    got, gcounts, grps = multihost.shard_rows_multihost(lambda a, b: docs[a:b], 700, 16, torch.float32, mesh,
                                                        pad_multiple=64)
    want, wcounts, wrps = shard_rows(ShardStore.build(docs, [str(i) for i in range(700)], dtype="float32"),
                                     mesh, pad_multiple=64)
    assert grps == wrps and [int(c) for c in gcounts] == [int(c) for c in wcounts]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # a range outside the process-local window raises
    monkeypatch.setattr(multihost, "process_local_rows", lambda n, rps, mesh=None: range(0, 192))
    with pytest.raises(RuntimeError, match="non-local shard requested"):
        multihost.shard_rows_multihost(lambda a, b: docs[a:b], 700, 16, torch.float32, mesh, pad_multiple=64)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_search_parity():
    """Two processes, two CPU shards each: every rank uploads only its own
    rows and every search's merge crosses the process boundary."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [
        subprocess.Popen([sys.executable, __file__, str(rank), str(port)], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"two-process world timed out; partial output: {outs}")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} rc={p.returncode}:\n{out}"
        assert f"PARITY_OK {rank}" in out, f"rank {rank} output:\n{out}"


def _worker(rank: int, port: int) -> None:
    import torch.distributed as dist

    from codemix_dense_retrieval_torch.ops.sketch import fit_sketch, sketch_rows
    from codemix_dense_retrieval_torch.parallel import multihost
    from codemix_dense_retrieval_torch.parallel.sharded_search import (
        search_blocks,
        sharded_topk_ip,
        sharded_topk_ip_adaptive,
        sharded_topk_ip_sketch,
    )

    assert multihost.initialize_multihost(f"localhost:{port}", 2, rank, backend="gloo")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
    mesh = multihost.global_mesh(local_devices=["cpu", "cpu"])
    assert mesh.shape == {"shard": 4, "tp": 1} and mesh.first_shard == 2 * rank

    # every rank can build any row range, but may only be asked for its own
    n, dim, k, b = 1000, 64, 10, 16
    rng = np.random.default_rng(7)
    docs_full = rng.standard_normal((n, dim)).astype(np.float32)
    docs_full /= np.linalg.norm(docs_full, axis=1, keepdims=True)
    queries = rng.standard_normal((b, dim)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    asked = []

    def rows_fn(start, stop):
        asked.append((start, stop))
        local = multihost.process_local_rows(n, 256, mesh)
        assert local.start <= start and stop <= local.stop, (start, stop, local)
        return docs_full[start:stop]

    docs, counts, rps = multihost.shard_rows_multihost(rows_fn, n, dim, torch.float32, mesh, pad_multiple=32)
    assert rps == 256 and asked and len(docs) == 2
    assert [int(c) for c in counts] == [[256, 256], [256, 232]][rank]

    gathered = []
    real = dist.all_gather_into_tensor

    def recording(out, src, *a, **kw):
        gathered.append(src.numel())
        return real(out, src, *a, **kw)

    dist.all_gather_into_tensor = recording
    q = torch.from_numpy(queries)
    vals, gids = sharded_topk_ip(q, docs, counts, k, mesh=mesh, method="bins_xla", bin_size=8, tile_n=32)
    scores = queries @ docs_full.T
    order = np.lexsort((np.arange(n)[None, :].repeat(b, 0), -scores), axis=1)
    oracle = order[:, :k]
    np.testing.assert_array_equal(gids.numpy(), oracle)
    np.testing.assert_allclose(vals.numpy(), np.take_along_axis(scores, oracle, axis=1), rtol=0, atol=1e-5)
    assert gathered and max(gathered) <= b * k  # only the (B, k) payload crosses
    # query blocks: every process runs the same blocks (the smallest cut);
    # rank 1 asks for another block size and still joins rank 0's blocks
    blocks = []

    def blockwise(blk):
        blocks.append(len(blk))
        return sharded_topk_ip(blk, docs, counts, k, mesh=mesh, method="bins_xla", bin_size=8, tile_n=32)

    bv, bg = search_blocks(q, [5, 7][rank], rps, blockwise, mesh.shard_devices(), mesh)
    assert blocks == [5, 5, 5, 5] and torch.equal(bg, gids) and torch.equal(bv, vals)

    # the sketch tier: certificates AND-combine across the processes
    proj = torch.from_numpy(fit_sketch(docs_full, dim // 2))
    sk_tails = [sketch_rows(d, proj) for d in docs]
    s_vals, s_gids, cert = sharded_topk_ip_sketch(
        q, docs, counts, [s for s, _ in sk_tails], [t for _, t in sk_tails], proj, k, mesh=mesh,
        probe_bins=16, bin_size=8, super_size=2, tile_n=32)
    assert cert.shape == (b,)
    for qi in np.flatnonzero(cert.numpy()):
        np.testing.assert_array_equal(s_gids[qi].numpy(), oracle[qi])

    # the adaptive tier: the unselected bound's max across the processes
    a_vals, a_gids, stats = sharded_topk_ip_adaptive(q, docs, counts, k, mesh=mesh, probe_bins=2, tile_n=32)
    np.testing.assert_array_equal(a_gids.numpy(), oracle)
    assert 0.0 <= stats["certified_frac"] <= 1.0
    dist.all_gather_into_tensor = real
    dist.destroy_process_group()
    print(f"PARITY_OK {rank} cert={float(cert.float().mean()):.2f} "
          f"adaptive={stats['certified_frac']:.2f}", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _worker(int(sys.argv[1]), int(sys.argv[2]))
