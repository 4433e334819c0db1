"""ops/mix.py: the port's mix_and_renorm against the JAX package's on the
same numpy inputs (tolerance 1e-6 abs, f32)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codemix_dense_retrieval_torch.ops import mix as port_mix
from codemix_dense_retrieval_tpu.ops import mix as jax_mix

ATOL = 1e-6


def _vecs(seed, b=6, d=32):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((b, d)).astype(np.float32)
    s = rng.standard_normal((b, d)).astype(np.float32)
    return p, s


def _both(p, s, alpha, **kw):
    ref = np.asarray(jax_mix.mix_and_renorm(jnp.asarray(p), jnp.asarray(s), alpha, **kw))
    alpha_t = alpha if np.ndim(alpha) == 0 else torch.tensor(np.asarray(alpha, np.float32))
    got = port_mix.mix_and_renorm(torch.from_numpy(p), torch.from_numpy(s), alpha_t, **kw).numpy()
    return ref, got


@pytest.mark.parametrize("alpha", [0.0, 1e-9, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0 - 1e-9, 1.0])
def test_scalar_alpha_matches_jax(alpha):
    p, s = _vecs(1)
    ref, got = _both(p, s, alpha)
    assert got.shape == ref.shape == p.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("normalize_endpoints", [False, True])
def test_alpha_vector_sweep_matches_jax(normalize_endpoints):
    p, s = _vecs(2)
    alphas = [0.0, 0.1, 0.5, 0.9, 1.0]
    ref, got = _both(p, s, alphas, normalize_endpoints=normalize_endpoints)
    assert got.shape == (5,) + p.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_endpoints_pass_through_unnormalized():
    p, s = _vecs(3)
    p *= 3.0
    _, got0 = _both(p, s, 0.0)
    _, got1 = _both(p, s, 1.0)
    np.testing.assert_array_equal(got0, p)
    np.testing.assert_array_equal(got1, s)


@pytest.mark.parametrize("alpha", [0.3, 0.7])
def test_non_finite_rows_fall_back_to_nearer_endpoint(alpha):
    p, s = _vecs(4)
    p[1, 3] = np.inf
    s[2, 0] = np.nan
    ref, got = _both(p, s, alpha)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    fallback = s if alpha > 0.5 else p
    for row in (1, 2):
        np.testing.assert_array_equal(got[row], fallback[row])


def test_l2_normalize_matches_jax():
    p, _ = _vecs(5)
    p[0] = 0.0
    ref = np.asarray(jax_mix.l2_normalize(jnp.asarray(p)))
    got = port_mix.l2_normalize(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
