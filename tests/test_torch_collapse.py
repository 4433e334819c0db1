"""ops/collapse.py: the port's on-device bilingual collapse against the JAX
package's collapse_topk_parallel_hub on the same inputs, ids and values
exactly: planted ties (equal scores across bases and within a base), fewer
distinct bases than k_out (-1 padding), pad rows at float32 min and signed
zeros."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.ops.collapse import NEG_INF, collapse_topk_parallel_hub
from codemix_dense_retrieval_tpu.ops import collapse as ref

F32_MIN = np.finfo(np.float32).min


def _both(vals, gids, n_first, k_out):
    rv, ri = ref.collapse_topk_parallel_hub(jnp.asarray(vals), jnp.asarray(gids, jnp.int32), n_first, k_out=k_out)
    pv, pi = collapse_topk_parallel_hub(torch.from_numpy(vals), torch.from_numpy(gids.astype(np.int64)),
                                        n_first, k_out=k_out)
    return (np.asarray(rv), np.asarray(ri)), (pv.numpy(), pi.numpy())


def _hub_results(seed, b=8, k=60, n_first=500, tie_levels=None):
    """Search-like rows: (score desc) over both languages' rows of random
    bases; ``tie_levels`` draws the scores from that many values, so ties
    fall within and across bases."""
    rng = np.random.default_rng(seed)
    vals = np.empty((b, k), np.float32)
    gids = np.empty((b, k), np.int64)
    for i in range(b):
        bases = rng.choice(n_first, size=k, replace=True)
        lang2 = rng.random(k) < 0.5
        g = np.where(lang2, bases + n_first, bases)
        v = (rng.integers(0, tie_levels, k) / tie_levels if tie_levels else rng.standard_normal(k))
        order = np.lexsort((g, -v))
        vals[i], gids[i] = v[order].astype(np.float32), g[order]
    return vals, gids, n_first


@pytest.mark.parametrize("seed, tie_levels, k_out", [
    (0, None, 20), (1, 7, 20), (2, 3, 60), (3, None, 60),
])
def test_collapse_equals_jax(seed, tie_levels, k_out):
    vals, gids, n_first = _hub_results(seed, tie_levels=tie_levels)
    (rv, ri), (pv, pi) = _both(vals, gids, n_first, k_out)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pv.view(np.int32), rv.view(np.int32))


def test_fewer_bases_than_k_out_pads_with_minus_one():
    vals = np.array([[3.0, 2.0, 1.0, 0.5], [1.0, 1.0, 1.0, 1.0]], np.float32)
    gids = np.array([[5, 1005, 7, 1007], [1009, 3, 9, 1003]])
    (rv, ri), (pv, pi) = _both(vals, gids, 1000, k_out=4)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pv, rv)
    assert pi.tolist() == [[5, 7, -1, -1], [3, 9, -1, -1]]
    assert (pv[:, 2:] == np.float32(NEG_INF)).all()


def test_pad_rows_at_float32_min_and_signed_zeros():
    """Rows past the valid count come back from the search at float32 min;
    they collapse to -1 like the duplicates. -0.0 and 0.0 tie."""
    vals = np.array([[0.5, 0.0, -0.0, F32_MIN, F32_MIN, F32_MIN],
                     [F32_MIN] * 6,
                     [-0.0, 0.0, -0.0, 0.0, F32_MIN, F32_MIN]], np.float32)
    gids = np.array([[2, 13, 4, 30, 31, 32],
                     [30, 31, 32, 33, 34, 35],
                     [12, 1, 11, 3, 30, 31]])
    (rv, ri), (pv, pi) = _both(vals, gids, 10, k_out=5)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pv.view(np.int32), rv.view(np.int32))
    assert (pi[1] == -1).all() and pi[0, :3].tolist() == [2, 3, 4]
