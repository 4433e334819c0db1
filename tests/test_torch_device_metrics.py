"""evals/device_metrics.py: the port's on-device metrics against the JAX
package's topk_metrics (atol 1e-6; both sum in f32, in another order) over
unjudged queries, qrels queries absent from the run (extra_zero_queries),
num_rel > k and k below the largest cutoff; build_rel_matrix equal; and,
x100, the port's host evaluator on binary qrels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.evals import device_metrics as port
from codemix_dense_retrieval_torch.evals.evaluate import evaluate_run
from codemix_dense_retrieval_tpu.evals import device_metrics as ref


def _case(seed, b=10, n=200, k=25, n_rel=(1, 6), judged=None):
    """(top-k ids (B, k), ragged relevant rows, scores (B, n)): each query's
    ranking is its scores' order; ``judged`` queries have relevant rows."""
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((b, n))
    topk = np.argsort(-scores, axis=1)[:, :k].astype(np.int32)
    rel_rows = []
    for i in range(b):
        if judged is not None and i >= judged:
            rel_rows.append([])
            continue
        m = rng.integers(*n_rel) if isinstance(n_rel, tuple) else n_rel
        rels = rng.choice(n, size=m, replace=False)
        # plant some hits inside the top-k
        rels[: m // 2] = topk[i, rng.choice(k, size=m // 2, replace=False)]
        rel_rows.append(sorted(set(rels.tolist())))
    return topk, rel_rows, scores


CASES = {
    "binary": dict(seed=0),
    "unjudged": dict(seed=1, judged=6),
    "num_rel_gt_k": dict(seed=2, k=10, n_rel=20),
    "k_below_cutoff": dict(seed=3, k=7),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("extra_zero", [0, 2])
def test_topk_metrics_equal_jax(name, extra_zero):
    topk, rel_rows, _ = _case(**CASES[name])
    rel = port.build_rel_matrix(rel_rows)
    np.testing.assert_array_equal(rel, ref.build_rel_matrix(rel_rows))
    cutoffs = (1, 3, 5, 10, 100)
    got = port.topk_metrics(torch.from_numpy(topk.astype(np.int64)), torch.from_numpy(rel), cutoffs, extra_zero)
    want = ref.topk_metrics(jnp.asarray(topk), jnp.asarray(rel), cutoffs, extra_zero)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == torch.float32
        assert float(got[key]) == pytest.approx(float(want[key]), abs=1e-6), key


def test_build_rel_matrix_edges():
    for rows in ([], [[]], [[3], [], [1, 2, 5]]):
        np.testing.assert_array_equal(port.build_rel_matrix(rows), ref.build_rel_matrix(rows))


@pytest.mark.parametrize("name", ["binary", "unjudged", "num_rel_gt_k", "k_below_cutoff"])
def test_x100_equals_the_host_evaluator(name):
    """On binary qrels: device metric x 100 == the port's host evaluator,
    which means over the qrels queries (the judged ones) plus 2 qrels
    queries that the run lacks."""
    topk, rel_rows, scores = _case(**CASES[name])
    qrels, run = {}, {}
    for i, rels in enumerate(rel_rows):
        run[f"q{i}"] = [(f"d{j}", float(scores[i, j])) for j in topk[i]]
        if rels:
            qrels[f"q{i}"] = {f"d{j}": 1 for j in rels}
    qrels["qx1"], qrels["qx2"] = {"d0": 1}, {"d1": 1, "d2": 1}
    tokens = ["MRR@1", "MRR@10", "P@5", "P@10", "Recall@5", "Recall@100", "nDCG@5", "nDCG@10",
              "nDCG@100", "AP"]
    host, _, _ = evaluate_run(run, qrels, tokens)
    got = port.topk_metrics(torch.from_numpy(topk.astype(np.int64)),
                            torch.from_numpy(port.build_rel_matrix(rel_rows)), extra_zero_queries=2)
    for key, val in host.items():
        if key in got:
            assert float(got[key]) * 100 == pytest.approx(val, abs=1e-4), key
