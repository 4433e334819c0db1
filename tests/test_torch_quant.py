"""ops/quant.py: per-row int8 quantization and int8 inner products are
bit-identical to the JAX package's (numpy host path, torch on-device path),
zero rows included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.ops import quant as port
from codemix_dense_retrieval_tpu.ops import quant as ref


def _rows(seed, n=64, d=48):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[3] = 0.0                           # zero row: scale 1.0, values 0
    x[5] = np.linspace(-2.5, 2.5, d)     # exact .5 steps after scaling hit rint's ties
    x[7] *= 1e-30                        # tiny but nonzero
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_rows_np_matches_jax(seed):
    x = _rows(seed)
    q, s = port.quantize_rows_np(x)
    rq, rs = ref.quantize_rows_np(x)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, rq)
    np.testing.assert_array_equal(s.view(np.uint32), rs.view(np.uint32))
    assert s[3] == 1.0 and (q[3] == 0).all()
    assert np.abs(q).max() == 127


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_rows_torch_matches_jax_device_path(seed):
    x = _rows(seed)
    q, s = port.quantize_rows(torch.from_numpy(x))
    rq, rs = ref.quantize_rows(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32), np.asarray(rs).view(np.uint32))
    hq, hs = port.quantize_rows_np(x)
    np.testing.assert_array_equal(q.numpy(), hq)
    np.testing.assert_array_equal(s.numpy(), hs)


def test_int8_ip_scores_and_dequantize_match_jax():
    qv, qs = port.quantize_rows_np(_rows(3, n=9))
    dv, ds = port.quantize_rows_np(_rows(4, n=70))
    got = port.int8_ip_scores(*map(torch.from_numpy, (qv, qs, dv, ds))).numpy()
    want = np.asarray(ref.int8_ip_scores(*map(jnp.asarray, (qv, qs, dv, ds))))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    deq = port.dequantize(torch.from_numpy(dv), torch.from_numpy(ds)).numpy()
    np.testing.assert_array_equal(deq, np.asarray(ref.dequantize(jnp.asarray(dv), jnp.asarray(ds))))


@pytest.mark.parametrize("dim", [1024, 1040, 2048])
def test_int8_ip_acc_is_exact_past_the_f32_mantissa(dim):
    """All-±127 rows make |acc| reach 127^2 * d, above 2^24 at d = 2048:
    the K-chunked integer sum stays exact."""
    rng = np.random.default_rng(dim)
    qv = (rng.integers(0, 2, (3, dim)) * 254 - 127).astype(np.int8)
    dv = (rng.integers(0, 2, (5, dim)) * 254 - 127).astype(np.int8)
    qv[0] = 127
    dv[0] = 127                       # acc = 127^2 * d exactly
    want = qv.astype(np.int64) @ dv.astype(np.int64).T
    got = port.int8_ip_acc(torch.from_numpy(qv), torch.from_numpy(dv))
    np.testing.assert_array_equal(got.to(torch.int64).numpy(), want)
    assert int(got[0, 0]) == 127 * 127 * dim
