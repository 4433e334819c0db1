"""ops/flash_attention.py: the port's plain flash attention (kernel B's
plain version) against the JAX package's Pallas kernel in interpret mode and
its XLA path, and the port's plain XLA-equivalent path against the JAX
one. f32 inputs, tolerance 1e-5 abs; fully masked rows exactly 0. Cases at
Qwen3's head shape (dh = 128, two q heads per KV head, causal) run below
one 128-row tile (S = 16, 64) and across tile edges (S = 260). Kernel B's
tile order (``tile_schedule``) against a numpy model of it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codemix_dense_retrieval_torch.ops import flash_attention as port
from codemix_dense_retrieval_tpu.ops import flash_attention as ref

ATOL = 1e-5


def _qkv(seed, b=2, h=4, kvh=4, s=200, dh=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, dh)).astype(np.float32)
    k = rng.standard_normal((b, kvh, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, kvh, s, dh)).astype(np.float32)
    return q, k, v


def _segments(lengths, s, seed):
    rng = np.random.default_rng(seed)
    seg = np.zeros((len(lengths), s), np.int32)
    for i, n in enumerate(lengths):
        cuts = np.sort(rng.choice(np.arange(1, max(n, 2)), size=min(3, max(n - 1, 0)), replace=False))
        ids = np.searchsorted(cuts, np.arange(n), side="right") + 1
        seg[i, :n] = ids
    return seg


CASES = {
    "plain": dict(lengths=[200, 137], causal=False, kvh=4, seg=False, seed=3),
    "zero_length": dict(lengths=[0, 150], causal=False, kvh=4, seg=False, seed=6),
    "causal": dict(lengths=[200, 90], causal=True, kvh=4, seg=False, seed=0),
    "gqa": dict(lengths=[180, 200], causal=False, kvh=2, seg=False, seed=1),
    "gqa_causal": dict(lengths=[200, 0], causal=True, kvh=2, seg=False, seed=2),
    "segments": dict(lengths=[200, 120], causal=False, kvh=4, seg=True, seed=4),
    "segments_causal_gqa": dict(lengths=[160, 200], causal=True, kvh=2, seg=True, seed=5),
    # Qwen3's head shape below one 128-row tile (kernel B's head-pair tiles)
    "qwen3_s16": dict(lengths=[16, 9], causal=True, kvh=2, seg=False, seed=7, s=16, dh=128),
    "qwen3_s16_segments": dict(lengths=[16, 11], causal=True, kvh=2, seg=True, seed=8, s=16, dh=128),
    "qwen3_s64": dict(lengths=[64, 37], causal=True, kvh=2, seg=False, seed=9, s=64, dh=128),
    "qwen3_s64_segments": dict(lengths=[50, 64], causal=True, kvh=2, seg=True, seed=10, s=64, dh=128),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_matches_pallas_and_xla(case):
    c = CASES[case]
    q, k, v = _qkv(c["seed"], kvh=c["kvh"], s=c.get("s", 200), dh=c.get("dh", 16))
    lengths = np.asarray(c["lengths"], np.int32)
    seg = _segments(lengths, q.shape[2], 5) if c["seg"] else None
    jseg = None if seg is None else jnp.asarray(seg)
    want_flash = np.asarray(ref.attention_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        block_q=64, block_k=64, window=128, interpret=True, causal=c["causal"],
        segment_ids=jseg,
    ))
    tseg = None if seg is None else torch.from_numpy(seg)
    got = port.attention_flash(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), causal=c["causal"], segment_ids=tseg,
    ).numpy()
    np.testing.assert_allclose(got, want_flash, atol=ATOL, rtol=0)
    # rows that see no valid key: exactly zero on both sides
    dead = np.zeros(got.shape[:3], bool)
    dead[lengths == 0] = True
    if seg is not None:
        dead |= (seg == 0)[:, None, :]
    assert (got[dead] == 0).all() and (want_flash[dead] == 0).all()

    want_xla = np.asarray(ref.attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        causal=c["causal"], segment_ids=jseg,
    ))
    got_xla = port.attention_xla(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), causal=c["causal"], segment_ids=tseg,
    ).numpy()
    np.testing.assert_allclose(got_xla, want_xla, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, got_xla, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal_gqa_seg", [False, True, "qwen3", "qwen3_segments"])
def test_plain_flash_matches_pallas_at_tile_edges(causal_gqa_seg):
    """Lengths around kernel B's 128-key tiles (0, 1, 127, 128, 129, S) and
    a sequence length that is not a multiple of its 128-query tiles: the
    plain version the card holds the kernel to, against the Pallas kernel;
    "qwen3*" at Qwen3's head shape (dh = 128, 4 q heads over 2 KV heads,
    causal), without and with segment ids."""
    s = 260
    lengths = np.asarray([0, 1, 127, 128, 129, s], np.int32)
    qwen3 = isinstance(causal_gqa_seg, str)
    with_seg = causal_gqa_seg is True or causal_gqa_seg == "qwen3_segments"
    causal = causal_gqa_seg is True or qwen3
    kvh = 2 if causal else 4
    seed = {False: 100, True: 101, "qwen3": 102, "qwen3_segments": 103}[causal_gqa_seg]
    q, k, v = _qkv(seed, b=len(lengths), kvh=kvh, s=s, dh=128 if qwen3 else 16)
    seg = _segments(lengths, s, 9) if with_seg else None
    want = np.asarray(ref.attention_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        block_q=64, block_k=64, window=128, interpret=True, causal=causal,
        segment_ids=None if seg is None else jnp.asarray(seg),
    ))
    got = port.attention_flash(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), causal=causal,
        segment_ids=None if seg is None else torch.from_numpy(seg),
    ).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert (got[0] == 0).all() and (want[0] == 0).all()
    if seg is not None:
        dead = np.broadcast_to((seg == 0)[:, None, :], got.shape[:3])
        assert (got[dead] == 0).all()


def _heads_view(dtype, head_dim=64, pad=0):
    """A (B, H, S, dh) view of (B, S, H, dh + pad) storage, as the encoder's
    projections hand it to kernel B."""
    x = torch.zeros(2, 8, 4, head_dim + pad, dtype=dtype)
    return x[..., :head_dim].transpose(1, 2)


def _shifted(dtype):
    flat = torch.zeros(2 * 8 * 4 * 64 + 8, dtype=dtype)
    return flat[1 : 1 + 2 * 8 * 4 * 64].view(2, 8, 4, 64).transpose(1, 2)


@pytest.mark.parametrize("case,dtype,ok", [
    ("heads_view", torch.bfloat16, True),
    ("heads_view", torch.float32, True),
    ("row_pad_8", torch.bfloat16, True),        # 72 bf16 = 144 bytes per row
    ("row_pad_4", torch.bfloat16, False),       # 68 bf16 = 136 bytes: not a multiple of 16
    ("row_pad_4", torch.float32, True),         # 68 f32 = 272 bytes
    ("shifted_start", torch.bfloat16, False),   # start 2 bytes past an aligned one
    ("broadcast_batch", torch.bfloat16, False), # stride 0
    ("strided_head_dim", torch.bfloat16, False),
])
def test_check_strided_operand(case, dtype, ok):
    t = {
        "heads_view": lambda: _heads_view(dtype),
        "row_pad_8": lambda: _heads_view(dtype, pad=8),
        "row_pad_4": lambda: _heads_view(dtype, pad=4),
        "shifted_start": lambda: _shifted(dtype),
        "broadcast_batch": lambda: torch.zeros(1, 8, 4, 64, dtype=dtype).expand(2, 8, 4, 64).transpose(1, 2),
        "strided_head_dim": lambda: torch.zeros(2, 4, 64, 8, dtype=dtype).transpose(2, 3),
    }[case]()
    assert t.shape[3] == 64
    if ok:
        port.check_strided_operand("q", t)
    else:
        with pytest.raises(ValueError, match="16 bytes"):
            port.check_strided_operand("q", t)


@pytest.mark.parametrize("s,packed,expect", [
    (511, False, "xla"), (512, False, "xla"), (513, False, "flash"),
    (511, True, "xla"), (512, True, "flash"),
])
def test_multi_head_attention_dispatch(monkeypatch, s, packed, expect):
    seen = []
    real_flash, real_xla = port.attention_flash, port.attention_xla
    monkeypatch.setattr(port, "attention_flash",
                        lambda *a, **k: seen.append("flash") or real_flash(*a, **k))
    monkeypatch.setattr(port, "attention_xla",
                        lambda *a, **k: seen.append("xla") or real_xla(*a, **k))
    x = torch.zeros(1, s, 8)
    mask = torch.ones(1, s, dtype=torch.int32)
    seg = torch.ones(1, s, dtype=torch.int32) if packed else None
    out = port.multi_head_attention(x, x, x, mask, num_heads=2, segment_ids=seg)
    assert out.shape == (1, s, 8)
    assert seen == [expect]
    seen.clear()
    port.multi_head_attention(x, x, x, mask, num_heads=2, segment_ids=seg, use_flash=False)
    assert seen == ["xla"]


def test_multi_head_attention_matches_jax_past_crossover():
    rng = np.random.default_rng(0)
    b, s, h, dh = 2, 520, 2, 16
    q, k, v = (rng.standard_normal((b, s, h * dh)).astype(np.float32) for _ in range(3))
    mask = np.zeros((b, s), np.int32)
    mask[0, :520] = 1
    mask[1, :300] = 1
    want = np.asarray(ref.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        num_heads=h, flash_min_seq=512,
    ))
    got = port.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(mask),
        num_heads=h,
    ).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _schedule_model(b, h, kvh, s, causal, grid):
    """Kernel B's tile order written out as loops: head pairs at S <= 64 with
    an even GQA group; causal, chunks of whole sequences (about 8 waves of
    ``grid`` tiles, spread evenly), heaviest query tile first and (batch,
    head) fastest inside a chunk; else query tile fastest."""
    n_qt = -(-s // 128)
    if s <= 64 and (h // kvh) % 2 == 0:
        return [(0, bb, hh) for bb in range(b) for hh in range(0, h, 2)]
    if not causal:
        return [(qt * 128, bb, hh) for bb in range(b) for hh in range(h) for qt in range(n_qt)]
    want = max(1, -(-8 * grid // (h * n_qt)))
    chunks = -(-b // want)
    chunk_b = -(-b // chunks)
    out = []
    for b0 in range(0, b, chunk_b):
        for qt in reversed(range(n_qt)):
            out += [(qt * 128, bb, hh) for bb in range(b0, min(b, b0 + chunk_b)) for hh in range(h)]
    return out


@pytest.mark.parametrize("b,h,kvh,s,causal", [
    (32, 16, 8, 1024, True),    # Qwen3 passages
    (32, 16, 8, 512, True),
    (128, 16, 8, 256, True),    # Qwen3 queries
    (128, 16, 8, 64, True),     # head pairs
    (7, 16, 8, 1024, True),     # a last chunk of fewer sequences
    (32, 16, 16, 1024, False),  # BGE-M3
    (3, 4, 4, 40, True),        # one head per KV head: no pairs
])
def test_tile_schedule_matches_model(b, h, kvh, s, causal):
    mode, tiles = port.tile_schedule(b, h, kvh, s, causal, grid=132)
    want = _schedule_model(b, h, kvh, s, causal, 132)
    assert [tuple(t) for t in tiles.tolist()] == want
    assert mode == ("head_pairs" if s <= 64 and (h // kvh) % 2 == 0 else "causal" if causal else "query_fastest")
    if mode != "head_pairs":  # every (query tile, batch, head) exactly once
        assert len(set(want)) == -(-s // 128) * b * h
    lengths = np.full(b, s)
    balance = port.schedule_balance(tiles, lengths, causal, grid=132)
    if causal and s >= 256 and b >= 32:
        # the query-fastest order that causal tiles left: each block alternates
        # two query tiles, the busiest ~1.37x the mean at S = 1024
        _, fastest = port.tile_schedule(b, h, kvh, s, False, grid=132)
        assert port.schedule_balance(fastest, lengths, True, grid=132) > 1.3
        assert balance <= 1.06
