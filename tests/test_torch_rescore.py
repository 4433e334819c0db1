"""The rescore search: kernel 5's plain version (bin maxima only) against the
JAX package's ``_binmax_only_pallas`` (interpret mode), and the rescore
top-k entry points against the JAX package's on the same numpy inputs.

Tolerances: bin maxima 1e-5 abs (both sides sum the same f32 or exact bf16
products, in different orders); rescored values 1e-5 abs; ids exactly equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codemix_dense_retrieval_torch.ops import topk as port
from codemix_dense_retrieval_tpu.ops import topk as ref

NEG_INF = np.float32(np.finfo(np.float32).min)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bin_size", [8, 16])
def test_binmax_only_plain_matches_pallas(bin_size, dtype):
    rng = np.random.default_rng(bin_size)
    b, n, d, n_valid = 8, 1024, 64, 1000 - 13
    q, x = _unit(rng, b, d), _unit(rng, n, d)
    jdt = getattr(jnp, dtype)
    want = np.asarray(ref._binmax_only_pallas(
        jnp.asarray(q, jdt), jnp.asarray(x, jdt), bin_size, n_valid,
        tile_b=8, tile_n=512, interpret=True,
    )).T
    tdt = getattr(torch, dtype)
    got = port.binmax_only(torch.from_numpy(q).to(tdt), torch.from_numpy(x).to(tdt), n_valid, bin_size)
    assert got.shape == want.shape == (b, n // bin_size) and got.dtype == torch.float32
    got = got.numpy()
    live = want > NEG_INF
    assert (got[~live] == NEG_INF).all() and live[:, : n_valid // bin_size].all()
    np.testing.assert_allclose(got[live], want[live], atol=1e-5, rtol=0)
    # the same maxima as kernel A's plain version, which also stores the scores
    _, bm = port.bin_scores_plain(torch.from_numpy(q).to(tdt), torch.from_numpy(x).to(tdt),
                                  n_valid, bin_size)
    np.testing.assert_array_equal(got, bm.numpy())


@pytest.mark.parametrize("bin_size", [8, 16])
@pytest.mark.parametrize("b", [1, 65, 129, 257])
def test_binmax_only_plain_matches_pallas_at_kernel_tile_edges(b, bin_size):
    """The card's oracle for kernel 5 at kernel A's tile edges: one query,
    one past the 64- and 128-wide query tiles, two 256-query tiles; d = 96,
    half of a 64-dim chunk; n_valid inside the first 128-row tile."""
    rng = np.random.default_rng(4000 + b)
    n, d, n_valid = 1024, 96, 100
    q, x = _unit(rng, b, d), _unit(rng, n, d)
    want = np.asarray(ref._binmax_only_pallas(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16), bin_size, n_valid,
        tile_b=b, tile_n=512, interpret=True,
    )).T
    got = port.binmax_only(torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(x).to(torch.bfloat16),
                           n_valid, bin_size).numpy()
    assert got.shape == want.shape == (b, n // bin_size)
    first_pad = -(-n_valid // bin_size)
    assert (got[:, first_pad:] == NEG_INF).all() and (want[:, first_pad:] == NEG_INF).all()
    np.testing.assert_allclose(got[:, :first_pad], want[:, :first_pad], atol=1e-5, rtol=0)


def _run_both(name, qs, docs, k, **kw):
    if name == "bins_rescore":
        rv, ri = ref.topk_ip(jnp.asarray(qs), jnp.asarray(docs), k, method="bins_rescore",
                             bin_size=16, interpret=True, **kw)
        gv, gi = port.topk_ip(torch.from_numpy(qs), torch.from_numpy(docs), k,
                              method="bins_rescore", bin_size=16, **kw)
    else:
        rv, ri = ref.topk_ip_rescore_two_level(jnp.asarray(qs), jnp.asarray(docs), k, bin_size=8,
                                               super_size=4, interpret=True, **kw)
        gv, gi = port.topk_ip_rescore_two_level(torch.from_numpy(qs), torch.from_numpy(docs), k,
                                                bin_size=8, super_size=4, **kw)
    return np.asarray(rv), np.asarray(ri), gv.numpy(), gi.numpy()


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("name", ["bins_rescore", "rescore_two_level"])
def test_rescore_topk_matches_jax(name, k):
    rng = np.random.default_rng(k + 50)
    qs, docs = _unit(rng, 16, 64), _unit(rng, 3000, 64)
    rv, ri, gv, gi = _run_both(name, qs, docs, k)
    assert gi.shape == (16, k)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_allclose(gv, rv, atol=1e-5, rtol=0)
    full = np.argsort(-(qs @ docs.T), axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(gi, full)


@pytest.mark.parametrize("name", ["bins_rescore", "rescore_two_level"])
def test_rescore_masks_pad_rows_and_n_valid(name):
    """Every real score negative and N not a tile multiple: zero-score pad
    rows and rows past n_valid must never be selected."""
    rng = np.random.default_rng(21)
    docs = -np.abs(_unit(rng, 1000, 16))
    qs = np.abs(_unit(rng, 4, 16))
    rv, ri, gv, gi = _run_both(name, qs, docs, 50, n_valid=900)
    assert gi.max() < 900
    np.testing.assert_array_equal(gi, ri)
    oracle = np.argsort(-(qs @ docs[:900].T), axis=1, kind="stable")[:, :50]
    np.testing.assert_array_equal(gi, oracle)


@pytest.mark.parametrize("name", ["bins_rescore", "rescore_two_level"])
def test_rescore_tie_break_lower_id_wins(name):
    rng = np.random.default_rng(7)
    base = rng.integers(-2, 3, size=(4, 16)).astype(np.float32) / 4
    docs = base[rng.integers(0, 4, size=2048)]
    qs = base[:3] * 0.5
    rv, ri, gv, gi = _run_both(name, qs, docs, 100)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gv, rv)
    for row_v, row_i in zip(gv, gi):
        tied = row_v[1:] == row_v[:-1]
        assert (row_i[1:][tied] > row_i[:-1][tied]).all()


def test_rescore_query_chunks_give_the_same_result(monkeypatch):
    """A budget small enough to force one query per chunk changes nothing."""
    rng = np.random.default_rng(31)
    q, docs = torch.from_numpy(_unit(rng, 6, 32)), torch.from_numpy(_unit(rng, 2048, 32))
    want = port.topk_ip_rescore_two_level(q, docs, 40)
    assert port._rescore_chunk(6, 56, 8, 32, 4) == 6
    monkeypatch.setattr(port, "_RESCORE_BUDGET", 1)
    assert port._rescore_chunk(6, 56, 8, 32, 4) == 1
    got = port.topk_ip_rescore_two_level(q, docs, 40)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    # the CPU batched product's summation order depends on the batch
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
