"""Sequence packing: models/packing.py, the packed forward and
pool_segments of models/xlmr.py, TextEncoder(pack=True) and
encode-corpus --pack, against the JAX package on the same inputs (weights
carried across from the Flax params) and against the port's unpacked path.

Tolerances are the JAX suite's (tests/test_packing.py): the packer's arrays
are equal; the packed forward sums in another order than the unpacked one
(and than XLA), so pooled embeddings agree within rtol 2e-4 / atol 2e-5,
and whole encodes within rtol 5e-4 / atol 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.io.shards import ShardStore
from codemix_dense_retrieval_torch.io.token_shards import TokenShardStore
from codemix_dense_retrieval_torch.models import packing as port
from codemix_dense_retrieval_torch.models.encoder import TextEncoder as PortEncoder
from codemix_dense_retrieval_torch.models.encoder import build_model
from codemix_dense_retrieval_torch.models.xlmr import XLMRConfig as PortCfg
from codemix_dense_retrieval_torch.models.xlmr import pool_segments
from codemix_dense_retrieval_tpu.models import packing as ref
from codemix_dense_retrieval_tpu.models import xlmr as ref_xlmr
from codemix_dense_retrieval_tpu.models.encoder import TextEncoder as RefEncoder

PAD = 1
TINY = dict(vocab_size=211, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            max_position_embeddings=80)


def _random_rows(rng, n, lo, hi, vocab=90):
    return sorted((rng.integers(2, vocab, size=rng.integers(lo, hi + 1)).astype(np.int32) for _ in range(n)),
                  key=len, reverse=True)


def _same(a, b):
    for name in ("ids", "segment_ids", "position_ids", "seg_starts", "seg_lengths", "placement"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


@pytest.mark.parametrize("n,lo,hi,seq_len,m,kw", [
    (57, 3, 30, 64, 8, {}),
    (40, 1, 20, 32, 4, {}),
    (300, 20, 120, 512, 16, {}),
    (11, 1, 40, 16, 2, {}),             # cut to seq_len, the max_segments cap
    (9, 1, 14, 32, 4, {"pos_offset": 0, "pos_pad": 0}),
])
def test_packing_arrays_equal_jax(n, lo, hi, seq_len, m, kw):
    rows = _random_rows(np.random.default_rng(n), n, lo, hi)
    got = port.pack_sequences(rows, seq_len, PAD, m, **kw)
    want = ref.pack_sequences(rows, seq_len, PAD, m, **kw)
    _same(got, want)
    assert port.packing_efficiency(got, seq_len) == ref.packing_efficiency(want, seq_len)
    _same(port.pad_rows_to(got, got.n_rows + 3, pad_id=PAD), ref.pad_rows_to(want, want.n_rows + 3, pad_id=PAD))
    assert port.pad_rows_to(got, got.n_rows, pad_id=PAD) is got


def test_pad_rows_to_needs_the_pad_id():
    p = port.pack_sequences([np.arange(2, 10, dtype=np.int32)], 8, PAD, 2)  # row 0 exactly full
    with pytest.raises(TypeError):
        port.pad_rows_to(p, 4)
    padded = port.pad_rows_to(p, 4, pad_id=PAD)
    assert (padded.ids[1:] == PAD).all() and (padded.segment_ids[1:] == 0).all()


@pytest.fixture(scope="module")
def params():
    model = ref_xlmr.XLMREncoder(ref_xlmr.XLMRConfig.tiny(**TINY, use_flash=False))
    ids = jnp.zeros((1, 8), jnp.int32)
    return jax.tree_util.tree_map(np.asarray, model.init(jax.random.key(0), ids, jnp.ones((1, 8), jnp.int32)))


def _packed_inputs(p):
    return [torch.from_numpy(a).long() for a in (p.ids, p.segment_ids, p.position_ids, p.seg_starts, p.seg_lengths)]


@pytest.mark.parametrize("pooling", ["cls", "mean", "last_token"])
def test_packed_forward_matches_jax_and_the_unpacked_forward(params, pooling):
    rng = np.random.default_rng(3)
    seq_len, m = 48, 6
    rows = _random_rows(rng, 11, 1, 20, vocab=TINY["vocab_size"])
    p = port.pack_sequences(rows, seq_len, PAD, m)
    model = ref_xlmr.XLMREncoder(ref_xlmr.XLMRConfig.tiny(**TINY, use_flash=False, pooling=pooling))
    want = np.asarray(model.apply(
        params, *(jnp.asarray(a) for a in (p.ids, p.segment_ids, p.position_ids, p.seg_starts, p.seg_lengths)),
        None, max_segments=m, method="packed_embeddings"))
    want_pooled, want_tok = model.apply(
        params, *(jnp.asarray(a) for a in (p.ids, p.segment_ids, p.position_ids, p.seg_starts, p.seg_lengths)),
        None, max_segments=m, method="packed_embed_with_tokens")
    pm = build_model(PortCfg.tiny(**TINY, use_flash=False, pooling=pooling), torch.device("cpu"), params)
    ids, seg, pos, starts, lens = _packed_inputs(p)
    with torch.no_grad():
        got = pm.packed_embeddings(ids, seg.int(), pos, starts, lens, max_segments=m).numpy()
        got_pooled, got_tok = pm.packed_embed_with_tokens(ids, seg.int(), pos, starts, lens, max_segments=m)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(want_pooled), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_tok.numpy(), np.asarray(want_tok), rtol=2e-4, atol=2e-5)
    used = np.zeros((p.n_rows, m), bool)
    used[p.placement[:, 0], p.placement[:, 1]] = True
    assert (got[~used] == 0).all()  # empty slots are exact zeros
    # the packed rows against one row per passage
    ids_u = np.full((len(rows), seq_len), PAD, np.int64)
    mask_u = np.zeros((len(rows), seq_len), np.int64)
    for i, toks in enumerate(rows):
        ids_u[i, : len(toks)] = toks
        mask_u[i, : len(toks)] = 1
    with torch.no_grad():
        unpacked = pm(torch.from_numpy(ids_u), torch.from_numpy(mask_u)).numpy()
    np.testing.assert_allclose(got[p.placement[:, 0], p.placement[:, 1]], unpacked, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("pooling", ["cls", "mean", "last_token"])
def test_pool_segments_matches_jax(pooling):
    rng = np.random.default_rng(4)
    p = port.pack_sequences(_random_rows(rng, 9, 1, 12), 24, PAD, 4)
    x = rng.standard_normal((p.n_rows, 24, 16)).astype(np.float32)
    want = ref_xlmr.pool_segments(jnp.asarray(x), *(jnp.asarray(a) for a in (p.segment_ids, p.seg_starts,
                                                                             p.seg_lengths)), pooling, True, 4)
    got = pool_segments(torch.from_numpy(x), torch.from_numpy(p.segment_ids), torch.from_numpy(p.seg_starts),
                        torch.from_numpy(p.seg_lengths), pooling, True, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def _texts(seed, n, hi):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{x}" for x in rng.integers(0, 400, rng.integers(2, hi))) for _ in range(n)]


@pytest.fixture(scope="module")
def encoders(params):
    kw = dict(length_buckets=(16, 32, 64))
    ref_enc = RefEncoder("test-enc", ref_xlmr.XLMRConfig.tiny(**TINY, use_flash=False, pooling="mean"),
                         params, **kw)
    port_enc = PortEncoder("test-enc", PortCfg.tiny(**TINY, use_flash=False, pooling="mean"), params,
                           device="cpu", **kw)
    return ref_enc, port_enc


def test_packed_encode_matches_jax_and_the_unpacked_encode(encoders):
    ref_enc, port_enc = encoders
    texts = _texts(7, 37, 60)
    got = port_enc.encode_documents(texts, batch_size=8, pack=True)
    stats = port_enc.last_phase_stats
    assert stats["batches"] >= 1 and stats["wall"] > 0
    np.testing.assert_allclose(got, ref_enc.encode_documents(texts, batch_size=8, pack=True), rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(got, port_enc.encode_documents(texts, batch_size=8), rtol=5e-4, atol=5e-5)
    bf = port_enc.encode_documents(texts, batch_size=8, pack=True, readback_dtype=torch.bfloat16)
    np.testing.assert_array_equal(bf, torch.from_numpy(got).to(torch.bfloat16).float().numpy())
    assert port_enc.encode_documents([], pack=True).shape == (0, TINY["hidden_size"])


def test_packed_encode_with_tokens_matches_jax_and_the_unpacked_encode(encoders):
    ref_enc, port_enc = encoders
    texts = _texts(10, 19, 50)
    rd, rt, rl = ref_enc.encode_documents_with_tokens(texts, batch_size=8, pack=True)
    pd, pt, pl = port_enc.encode_documents_with_tokens(texts, batch_size=8, pack=True)
    np.testing.assert_array_equal(pl, rl)
    np.testing.assert_allclose(pd, rd, rtol=5e-4, atol=5e-5)
    assert pt.shape == rt.shape
    np.testing.assert_allclose(pt.numpy(), rt, rtol=5e-4, atol=5e-5)
    ud, ut, ul = port_enc.encode_documents_with_tokens(texts, batch_size=8)
    np.testing.assert_array_equal(pl, ul)
    np.testing.assert_allclose(pd, ud, rtol=5e-4, atol=5e-5)
    t_cut = min(ut.shape[1], pt.shape[1])
    np.testing.assert_allclose(pt.numpy()[:, :t_cut], ut.numpy()[:, :t_cut], rtol=5e-4, atol=5e-5)
    for i, ln in enumerate(pl):
        assert (pt.numpy()[i, ln:] == 0).all()
    # max_tokens keeps each passage's first tokens, with its full valid count
    _, cut, cl = port_enc.encode_documents_with_tokens(texts, batch_size=8, pack=True, max_tokens=4)
    np.testing.assert_array_equal(cut.numpy(), pt.numpy()[:, :4])
    np.testing.assert_array_equal(cl, pl)


def test_cli_encode_corpus_pack(tmp_path):
    """encode-corpus --pack (with a token store) writes the rows the
    unpacked run writes, within the packed tolerance."""
    from codemix_dense_retrieval_torch.cli import main

    rng = np.random.default_rng(11)
    corpus = tmp_path / "c.tsv"
    # passages within the smoke model's longest bucket (32 tokens): past it
    # the unpacked path cuts a bucketed batch and the packed one tokenizes
    # to the cap, in both packages
    corpus.write_text("".join(f"c{i}\t{' '.join(f'w{x}' for x in rng.integers(0, 300, rng.integers(2, 30)))}\n"
                              for i in range(50)))
    base = ["encode-corpus", "--device", "cpu", "--smoke_dim", "32", "--corpus_tsv", f"xx={corpus}",
            "--storage_dtype", "float32", "--tokens_per_doc", "6", "--enc_batch", "16"]
    main([*base, "--out", str(tmp_path / "plain")])
    main([*base, "--out", str(tmp_path / "packed"), "--pack"])
    a, b = ShardStore.open(tmp_path / "plain" / "xx"), ShardStore.open(tmp_path / "packed" / "xx")
    assert a.docids == b.docids and b.count == 50
    np.testing.assert_allclose(np.asarray(b.vectors), np.asarray(a.vectors), rtol=5e-4, atol=5e-5)
    ta, tb = TokenShardStore.open(tmp_path / "plain" / "xx" / "tokens"), TokenShardStore.open(
        tmp_path / "packed" / "xx" / "tokens")
    assert tb.docids == ta.docids and tb.count == 50
    np.testing.assert_array_equal(tb.lengths, ta.lengths)
