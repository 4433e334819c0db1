"""Driver ``run_mix``: the paper's vector-mix experiment, as ``cli run-mix``
runs it without ``--fused``: ``pipeline.runs.run_vector_mix_search`` over a
``DenseFlatIndex`` on the card, whole alpha sweeps in a loop, each sweep's
TREC runs written into a directory of its own.

Traffic keys: ``queries`` (query pairs), ``second_language_noise``,
``planted_spread`` (one row per pair near its alpha = .5 mix), ``alphas``,
``k``, ``query_block``, ``sample_pairs`` (query-alpha pairs the check
compares). The configuration's ``index`` gives rows, dim and dtype.

The check reads every TREC file back: each query has k lines with ranks
1..k and k distinct ids of the index, else ``malformed`` counts it; a
sample of (sweep, alpha, query) drawn from the seed is held against the
reference's exact top-k of ``safe_mix`` rounded to the store's bfloat16.
``variant="control"`` searches an int8 copy of the rows instead (the
port's kernel-4 path): the precision below the configuration's.
"""

from __future__ import annotations

import pathlib
import shutil
import time
from typing import Dict

import numpy as np
import torch

from harness import compare, data
from reference import search as ref

# the traffic at a CPU test's size
TINY = {"queries": 300, "alphas": [0.0, 0.25, 0.5, 1.0], "k": 10, "query_block": 128, "sample_pairs": 96}


def _rows(ctx, a, b):
    cfg = ctx.config["index"]
    t = ctx.traffic
    mid = ref.safe_mix(a, b, 0.5)
    pos, planted = data.planted_rows(mid, cfg["rows"], t["planted_spread"], ctx.seed, ctx.device)
    return data.IndexRows(cfg["rows"], cfg["dim"], ctx.seed, ctx.device, planted_pos=pos, planted_rows=planted)


def setup(ctx) -> Dict:
    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex
    from codemix_dense_retrieval_torch.io.shards import ShardStore
    from codemix_dense_retrieval_torch.pipeline import runs

    t, cfg = ctx.traffic, ctx.config["index"]
    a, b = data.query_pairs(t["queries"], cfg["dim"], t["second_language_noise"], ctx.seed, ctx.device)
    rows = _rows(ctx, a, b)
    docids = [str(i) for i in range(cfg["rows"])]
    if ctx.variant == "control":
        codes, scales = _int8_store(rows)
        index = DenseFlatIndex(ShardStore.build(codes, docids, dtype="int8", scales=scales))
    else:
        index = DenseFlatIndex.build(rows.host(), docids, dtype=cfg["dtype"])
    index.to_device(ctx.device)
    qids = [str(i) for i in range(t["queries"])]
    a_np, b_np = a.cpu().numpy(), b.cpu().numpy()
    state = {"index": index, "qids": qids, "a": a_np, "b": b_np, "out": ctx.tmp / "runs",
             "write_s": 0.0, "runs": runs}
    _time_writer(state)
    # the window's shapes: every query block at k, one alpha inside (0, 1)
    # (the mix's interior branch) and the writer, built at first use
    runs.run_vector_mix_search(index, qids, a_np, b_np, [0.5], ctx.tmp / "warm", k=t["k"],
                               query_block=t["query_block"])
    shutil.rmtree(ctx.tmp / "warm")
    state["write_s"] = 0.0
    return state


def _int8_store(rows):
    """(int8 codes, f32 scales) of the rows, quantized on the card by the
    port's per-row quantizer (the rows of an ``--storage_dtype int8`` store)."""
    from codemix_dense_retrieval_torch.ops.quant import quantize_rows

    codes = torch.empty((rows.n, rows.d), dtype=torch.int8)
    scales = torch.empty(rows.n, dtype=torch.float32)
    for c0 in range(0, rows.n, data.ROW_CHUNK):
        c1 = min(rows.n, c0 + data.ROW_CHUNK)
        q, s = quantize_rows(rows(c0, c1))
        codes[c0:c1], scales[c0:c1] = q.cpu(), s.cpu()
    return codes, scales.numpy()


def _time_writer(state) -> None:
    """Time ``write_run`` as ``pipeline.runs`` calls it (a wrapper in that
    module's namespace; the port's code is not changed)."""
    runs = state["runs"]
    inner = runs.write_run

    def timed(*args, **kw):
        with torch.profiler.record_function("trec.write_run"):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kw)
            finally:
                state["write_s"] += time.perf_counter() - t0

    runs.write_run = timed
    state["restore"] = lambda: setattr(runs, "write_run", inner)


def window(ctx, state) -> Dict:
    t = ctx.traffic
    runs = state["runs"]
    sweeps = 0
    with ctx.window() as elapsed:
        while True:
            with torch.profiler.record_function("runs.run_vector_mix_search"):
                runs.run_vector_mix_search(state["index"], state["qids"], state["a"], state["b"], t["alphas"],
                                           state["out"] / f"sweep_{sweeps}", k=t["k"],
                                           query_block=t["query_block"])
            sweeps += 1
            if elapsed() >= ctx.seconds:
                break
    state["restore"]()
    state["sweeps"] = sweeps
    searches = sweeps * len(t["alphas"]) * t["queries"]
    blocks = -(-t["queries"] // t["query_block"])
    return {
        "e2e": {"sweep_qps": searches / ctx.window_s},
        "counters": {"searches": searches, "rows": ctx.config["index"]["rows"], "dim": ctx.config["index"]["dim"],
                     "padded_queries": sweeps * len(t["alphas"]) * blocks * t["query_block"],
                     "write_s": state["write_s"]},
        "attempted": searches,
        "failed": 0,
    }


def read_run(path: pathlib.Path, qids, k: int, n_rows: int):
    """(ids (Q, k) int64, scores (Q, k) f32, malformed query count) of a
    TREC file that should hold k lines per qid in qid order."""
    tok = path.read_text().split()
    q = len(qids)
    if len(tok) != 6 * q * k:
        return None, None, q
    try:
        return _parse_run(tok, qids, k, n_rows)
    except ValueError:   # a field that is not a number
        return None, None, q


def _parse_run(tok, qids, k: int, n_rows: int):
    q = len(qids)
    qcol = np.asarray(tok[0::6], dtype=object).reshape(q, k)
    ok = (qcol == np.asarray(qids, dtype=object)[:, None]).all(axis=1)
    ranks = np.asarray(tok[3::6], dtype=np.int64).reshape(q, k)
    ok &= (ranks == np.arange(1, k + 1)).all(axis=1)
    ids = np.asarray(tok[2::6], dtype=np.int64).reshape(q, k)
    ok &= ((ids >= 0) & (ids < n_rows)).all(axis=1)
    srt = np.sort(ids, axis=1)
    ok &= (srt[:, 1:] != srt[:, :-1]).all(axis=1)
    scores = np.asarray(tok[4::6], dtype=np.float32).reshape(q, k)
    return ids, scores, int((~ok).sum())


def check(ctx, state) -> Dict[str, float]:
    from codemix_dense_retrieval_torch.config import format_alpha
    from harness.core import free_device

    t, cfg = ctx.traffic, ctx.config["index"]
    k, qids, n_rows = t["k"], state["qids"], cfg["rows"]
    a, b = (torch.from_numpy(x).to(ctx.device) for x in (state["a"], state["b"]))
    sweeps, out = state["sweeps"], state["out"]
    for key in ("index", "runs", "restore"):
        state.pop(key, None)
    free_device(ctx.device)

    rng = data.np_rng(ctx.seed, "check")
    n_alpha = len(t["alphas"])
    pick = rng.choice(sweeps * n_alpha * len(qids), size=min(t["sample_pairs"], sweeps * n_alpha * len(qids)),
                      replace=False)
    want = {}
    for p in np.sort(pick):
        s, rest = divmod(int(p), n_alpha * len(qids))
        ai, qi = divmod(rest, len(qids))
        want.setdefault((s, ai), []).append(qi)
    malformed = 0
    served_ids, served_scores, queries = [], [], []
    for s in range(sweeps):
        for ai, alpha in enumerate(t["alphas"]):
            path = out / f"sweep_{s}" / f"cm-alpha-{format_alpha(alpha)}.trec"
            ids, scores, bad = read_run(path, qids, k, n_rows) if path.exists() else (None, None, len(qids))
            malformed += bad
            qi = want.get((s, ai))
            if not qi or ids is None:
                continue
            qi = np.asarray(qi)
            served_ids.append(torch.from_numpy(ids[qi]))
            served_scores.append(torch.from_numpy(scores[qi]))
            queries.append(ref.safe_mix(a[qi], b[qi], float(alpha)))
    shutil.rmtree(out, ignore_errors=True)
    numbers = {"malformed": float(malformed)}
    if queries:
        rows = _rows(ctx, a, b)
        q = torch.cat(queries).to(torch.bfloat16).to(torch.float32)     # the store's precision
        sid = torch.cat(served_ids).to(ctx.device)
        vals, _, picked = ref.exact_topk(q, lambda c0, c1: rows(c0, c1), n_rows, k, score_ids=sid)
        numbers.update(compare.topk_numbers(torch.cat(served_scores).to(ctx.device), vals, picked))
        numbers["pairs"] = float(len(q))
    return numbers


# Faults a run of this driver can have, each planted in the port underneath
# the timed path: ``FAULTS[name](cell) -> (object, attribute, replacement)``.

def _mix_unchanged(cell):
    from codemix_dense_retrieval_torch.pipeline import runs

    return runs, "mix_and_renorm", lambda p, s, a, **kw: p.to(torch.float32)


def _search_fault(kind):
    def plant(cell):
        from codemix_dense_retrieval_torch.index import flat

        inner = flat.sharded_topk_ip

        def broken(q, *args, **kw):
            if kind == "half":   # the block's second half answered with the first half's results
                h = (len(q) + 1) // 2
                v, i = inner(q[:h], *args, **kw)
                return torch.cat([v, v])[: len(q)], torch.cat([i, i])[: len(q)]
            v, i = inner(q, *args, **kw)   # the first and last hits of every list swapped
            i = i.clone()
            i[:, [0, -1]] = i[:, [-1, 0]]
            return v, i

        return flat, "sharded_topk_ip", broken

    return plant


FAULTS = {"state_unchanged": _mix_unchanged, "half_batch": _search_fault("half"),
          "answer_altered": _search_fault("swap")}
