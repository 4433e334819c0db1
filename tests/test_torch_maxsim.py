"""ops/maxsim.py: the plain MaxSim against the JAX package's XLA version and
its Pallas kernel (interpret mode), the zero-output contract, and the
rerank's (score desc, id asc) order. All f32 on the CPU: the two sum the
same products in another order, hence 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.ops import maxsim as port
from codemix_dense_retrieval_tpu.ops import maxsim as ref


def _data(seed, b=3, tq=8, k=5, td=16, d=32):
    rng = np.random.default_rng(seed)
    qt = rng.standard_normal((b, tq, d)).astype(np.float32)
    dt = rng.standard_normal((b, k, td, d)).astype(np.float32)
    qm = (rng.random((b, tq)) < 0.8).astype(np.int32)
    qm[:, 0] = 1
    dm = (rng.random((b, k, td)) < 0.8).astype(np.int32)
    dm[:, :, 0] = 1
    return qt, qm, dt, dm


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_xla_and_pallas(seed):
    qt, qm, dt, dm = _data(seed)
    got = port.maxsim_scores_plain(*_t(qt, qm, dt, dm)).numpy()
    want_xla = np.asarray(ref.maxsim_scores_xla(*map(jnp.asarray, (qt, qm, dt, dm))))
    want_pallas = np.asarray(ref.maxsim_scores_pallas(*map(jnp.asarray, (qt, qm, dt, dm)), interpret=True))
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=1e-5)
    # the CPU wrapper is the plain version
    np.testing.assert_array_equal(port.maxsim_scores(*_t(qt, qm, dt, dm)).numpy(), got)


def test_bf16_doc_tokens_match_jax():
    qt, qm, dt, dm = _data(2)
    dt_bf = jnp.asarray(dt, jnp.bfloat16)
    want = np.asarray(ref.maxsim_scores_xla(jnp.asarray(qt), jnp.asarray(qm), dt_bf, jnp.asarray(dm)))
    d_t = torch.from_numpy(dt).to(torch.bfloat16)
    got = port.maxsim_scores_plain(*_t(qt, qm), d_t, *_t(dm)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_zero_output_contract():
    qt, qm, dt, dm = _data(3)
    dm[0, 2] = 0          # a candidate with no valid token scores 0
    qm[1] = 0             # a query with no valid token scores 0 everywhere
    qm[2, 1:] = 0         # masked query tokens add 0
    got = port.maxsim_scores_plain(*_t(qt, qm, dt, dm)).numpy()
    want = np.asarray(ref.maxsim_scores_xla(*map(jnp.asarray, (qt, qm, dt, dm))))
    assert got[0, 2] == 0.0 and (got[1] == 0.0).all()
    sims = np.einsum("d,ktd->kt", qt[2, 0], dt[2])
    np.testing.assert_allclose(got[2], np.where(dm[2] > 0, sims, -np.inf).max(axis=1), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_rerank_sorts_by_score_then_lower_id():
    qt, qm, dt, dm = _data(4, k=6)
    dt[:, 3] = dt[:, 1]   # candidates 1 and 3 tie exactly
    dm[:, 3] = dm[:, 1]
    ids = np.array([[50, 9, 40, 7, 30, 20]] * 3, np.int32)
    rs, ri = ref.maxsim_rerank(*map(jnp.asarray, (qt, qm, dt, dm, ids)), use_pallas=False)
    ps, pi = port.maxsim_rerank(*_t(qt, qm, dt, dm, ids))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), rtol=0, atol=1e-5)
    for row_s, row_i in zip(ps.numpy(), pi.numpy()):
        pos7, pos9 = list(row_i).index(7), list(row_i).index(9)
        assert pos7 + 1 == pos9  # the tie goes to the lower id
        assert (np.diff(row_s) <= 0).all()


def test_wrapper_refuses_tensors_off_one_cuda_device():
    """Only two CPU tensors take the plain version; any other pair must lie
    on one CUDA device, so a host pointer never reaches the kernel."""
    qt, qm, dt, dm = _t(*_data(5))
    d_meta = torch.empty(dt.shape, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        port.maxsim_scores(qt, qm, d_meta, dm)
    with pytest.raises(ValueError, match="one CUDA device"):
        port.maxsim_scores(qt.to("meta"), qm, dt.to(torch.bfloat16), dm)
