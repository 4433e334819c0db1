"""io/token_shards.py: the port writes the JAX package's token store byte for
byte, each package reads the other's store, and a torn write resumes."""

import json

import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.io import token_shards as port
from codemix_dense_retrieval_torch.ops.quant import quantize_rows
from codemix_dense_retrieval_tpu.io import token_shards as ref


def _tokens(seed, n=40, t=10, d=16):
    rng = np.random.default_rng(seed)
    toks = rng.standard_normal((n, t, d)).astype(np.float32)
    toks /= np.linalg.norm(toks, axis=-1, keepdims=True)
    lens = rng.integers(0, t + 3, size=n)  # past t too: clamped by the writer
    return toks, lens, [f"doc{i}" for i in range(n)]


def _write(mod, out, toks, lens, ids, dtype, td=8, rows_per_file=16, batches=3):
    w = mod.TokenShardWriter(out, token_dim=toks.shape[2], tokens_per_doc=td, dtype=dtype,
                             lang="xx", encoder="enc", rows_per_file=rows_per_file)
    for part in np.array_split(np.arange(len(ids)), batches):
        w.append(toks[part], lens[part], [ids[i] for i in part], [f"{ids[i]}#xx" for i in part])
    w.finalize()


def test_quantize_tokens_equals_jax():
    """The writer's per-token int8 (per-row quantize_rows of the (n * T, d)
    tokens) equals the JAX package's _quantize_tokens_np bit for bit."""
    toks, _, _ = _tokens(0)
    toks[3, 2] = 0.0  # an all-zero token keeps scale 1
    n, t, d = toks.shape
    pq, ps = quantize_rows(torch.from_numpy(toks).reshape(n * t, d))
    pq, ps = pq.numpy().reshape(n, t, d), ps.numpy().reshape(n, t)
    rq, rs = ref._quantize_tokens_np(toks)
    np.testing.assert_array_equal(pq, rq)
    np.testing.assert_array_equal(ps, rs)
    assert ps[3, 2] == 1.0


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_store_is_byte_identical_to_jax(tmp_path, dtype):
    toks, lens, ids = _tokens(1)
    _write(port, tmp_path / "port", toks, lens, ids, dtype)
    _write(ref, tmp_path / "ref", toks, lens, ids, dtype)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len([n for n in names if n.startswith("emb.")]) == 3  # 40 rows, 16 per file
    for name in names:
        a, b = (tmp_path / "port" / name).read_bytes(), (tmp_path / "ref" / name).read_bytes()
        if name == "manifest.json":
            assert json.loads(a) == json.loads(b)
        else:
            assert a == b, name


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_each_package_reads_the_others_store(tmp_path, dtype):
    toks, lens, ids = _tokens(2)
    _write(ref, tmp_path / "ref", toks, lens, ids, dtype)
    _write(port, tmp_path / "port", toks, lens, ids, dtype)
    rows = np.array([0, 5, 17, 39, 5])
    for writer_dir in ("ref", "port"):
        p_store = port.TokenShardStore.open(tmp_path / writer_dir)
        r_store = ref.TokenShardStore.open(tmp_path / writer_dir)
        assert port.TokenShardStore.exists(tmp_path / writer_dir)
        assert p_store.count == r_store.count == 40 and p_store.docids == ids
        assert (p_store.tokens_per_doc, p_store.token_dim, p_store.dtype) == (8, 16, dtype)
        pt, pm = p_store.gather(rows)
        rt, rm = r_store.gather(rows)
        np.testing.assert_array_equal(pm, rm)
        np.testing.assert_array_equal(pt, rt)
        pq, ps, _ = p_store.gather_quantized(rows)
        rq, rs, _ = r_store.gather_quantized(rows)
        np.testing.assert_array_equal(pq.view(np.uint8), np.asarray(rq).view(np.uint8))
        if dtype == "int8":
            np.testing.assert_array_equal(ps, rs)
        # the store holds the clamped, masked, quantized blocks
        np.testing.assert_array_equal(p_store.lengths, np.minimum(lens, 8))
        in_ram = port.TokenShardStore.open(tmp_path / writer_dir, mmap=False)
        np.testing.assert_array_equal(in_ram.gather(rows)[0], pt)


def test_open_rejects_a_dense_store(tmp_path):
    from codemix_dense_retrieval_torch.io.shards import ShardStore

    ShardStore.build(np.ones((4, 8), np.float32), list("abcd")).save(tmp_path / "dense")
    assert not port.TokenShardStore.exists(tmp_path / "dense")
    assert not port.TokenShardStore.exists(tmp_path / "missing")
    with pytest.raises(ValueError, match="not a token shard store"):
        port.TokenShardStore.open(tmp_path / "dense")


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_resume_after_a_torn_write(tmp_path, dtype):
    """A crash after the sidecars of a batch but inside its rows: resume cuts
    the torn row and the run-ahead sidecars, and the finished store equals
    one written without the crash (and the JAX package's)."""
    toks, lens, ids = _tokens(3, n=30)
    out = tmp_path / "torn"
    w = port.TokenShardWriter(out, token_dim=16, tokens_per_doc=8, dtype=dtype, rows_per_file=16)
    w.append(toks[:12], lens[:12], ids[:12])
    # the next batch's sidecars landed, and half of one row of it
    row_bytes = 8 * 16 * (1 if dtype == "int8" else 2)
    with open(out / "lengths.bin", "ab") as fh:
        fh.write(np.asarray(lens[12:20], np.int32).tobytes())
    if dtype == "int8":
        with open(out / "token_scales.bin", "ab") as fh:
            fh.write(np.ones((8, 8), np.float32).tobytes())
    with open(out / "docids.partial.txt", "a") as fh:
        fh.write("".join(f"{d}\n" for d in ids[12:20]))
    with open(out / "emb.00000.bin", "ab") as fh:
        fh.write(b"\x01" * (row_bytes // 2))
    w2, done = port.TokenShardWriter.resume_partial(out, 16, 8, dtype, rows_per_file=16)
    assert w2.count == 12 and done == set(ids[:12])
    w2.append(toks[12:], lens[12:], ids[12:])
    w2.finalize()
    _write(ref, tmp_path / "ref", toks, lens, ids, dtype, batches=1)
    got = port.TokenShardStore.open(out)
    want = ref.TokenShardStore.open(tmp_path / "ref")
    assert got.docids == ids
    np.testing.assert_array_equal(got.gather(np.arange(30))[0], want.gather(np.arange(30))[0])
    np.testing.assert_array_equal(got.lengths, want.lengths)


def test_resume_refuses_missing_sidecars(tmp_path):
    toks, lens, ids = _tokens(4, n=6)
    w = port.TokenShardWriter(tmp_path / "s", token_dim=16, tokens_per_doc=8)
    w.append(toks, lens, ids)
    (tmp_path / "s" / "lengths.bin").unlink()
    with pytest.raises(ValueError, match="lengths.bin missing"):
        port.TokenShardWriter.resume_partial(tmp_path / "s", 16, 8)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_tensor_append_writes_the_same_bytes_as_numpy(tmp_path, dtype):
    """Token blocks handed over as a tensor (as the encoder hands them) give
    the store the JAX package writes from numpy."""
    toks, lens, ids = _tokens(5)
    _write(ref, tmp_path / "np", toks, lens, ids, dtype)
    _write(port, tmp_path / "t", torch.from_numpy(toks), lens, ids, dtype)
    for f in sorted((tmp_path / "np").iterdir()):
        got = (tmp_path / "t" / f.name).read_bytes()
        if f.name == "manifest.json":
            assert json.loads(got) == json.loads(f.read_bytes())
        else:
            assert got == f.read_bytes(), f.name
