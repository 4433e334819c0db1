"""ops/flash_attention.py: the port's plain flash attention (kernel B's
plain version) against the JAX package's Pallas kernel in interpret mode and
its XLA path, and the port's plain XLA-equivalent path against the JAX
one. f32 inputs, tolerance 1e-5 abs; fully masked rows exactly 0."""

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
    "plain": dict(lengths=[200, 137], causal=False, kvh=4, seg=False),
    "zero_length": dict(lengths=[0, 150], causal=False, kvh=4, seg=False),
    "causal": dict(lengths=[200, 90], causal=True, kvh=4, seg=False),
    "gqa": dict(lengths=[180, 200], causal=False, kvh=2, seg=False),
    "gqa_causal": dict(lengths=[200, 0], causal=True, kvh=2, seg=False),
    "segments": dict(lengths=[200, 120], causal=False, kvh=4, seg=True),
    "segments_causal_gqa": dict(lengths=[160, 200], causal=True, kvh=2, seg=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_matches_pallas_and_xla(case):
    c = CASES[case]
    q, k, v = _qkv(sorted(CASES).index(case), kvh=c["kvh"])
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


@pytest.mark.parametrize("causal_gqa_seg", [False, True])
def test_plain_flash_matches_pallas_at_tile_edges(causal_gqa_seg):
    """Lengths around kernel B's 128-key tiles (0, 1, 127, 128, 129, S) and
    a sequence length that is not a multiple of its 128-query tiles: the
    plain version the card holds the kernel to, against the Pallas kernel."""
    s = 260
    lengths = np.asarray([0, 1, 127, 128, 129, s], np.int32)
    kvh = 2 if causal_gqa_seg else 4
    q, k, v = _qkv(100 + int(causal_gqa_seg), b=len(lengths), kvh=kvh, s=s)
    seg = _segments(lengths, s, 9) if causal_gqa_seg else None
    want = np.asarray(ref.attention_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        block_q=64, block_k=64, window=128, interpret=True, causal=causal_gqa_seg,
        segment_ids=None if seg is None else jnp.asarray(seg),
    ))
    got = port.attention_flash(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), causal=causal_gqa_seg,
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
