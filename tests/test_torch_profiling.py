"""utils/profiling.py and utils/timing.py against the JAX package's:
maybe_trace as a no-op and with a CPU trace (a Chrome trace under
<dir>/<name>/), timed_device_fn's result and its wait on the result, and
the phase timers' accounting."""

import json
import logging
import time

import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.utils import profiling, timing
from codemix_dense_retrieval_tpu.utils import profiling as ref_profiling
from codemix_dense_retrieval_tpu.utils import timing as ref_timing


def test_maybe_trace_is_a_noop_without_a_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("CDR_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.maybe_trace("x"):
        torch.ones(3).sum()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("via_env", [False, True])
def test_maybe_trace_writes_a_chrome_trace(tmp_path, monkeypatch, via_env):
    if via_env:
        monkeypatch.setenv("CDR_PROFILE_DIR", str(tmp_path))
    with profiling.maybe_trace("search", None if via_env else str(tmp_path)):
        with timing.phase_timer("marked_span", trace=True):
            (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    trace = json.loads((tmp_path / "search" / "trace.json").read_text())
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert "marked_span" in names and any("mm" in str(n) for n in names)


def test_timed_device_fn_matches_the_jax_contract():
    calls = []

    def fn(x):
        calls.append(1)
        return (torch.from_numpy(x) * 2, None)

    x = np.ones(4, np.float32)
    got = profiling.timed_device_fn(fn, x, iters=3, warmup=2)
    want = ref_profiling.timed_device_fn(lambda a: (a * 2,), x, iters=3, warmup=2)
    assert set(got) == set(want) == {"mean_s", "iters"}
    assert got["iters"] == want["iters"] == 3 and got["mean_s"] > 0 and len(calls) == 5
    # numpy results (DenseFlatIndex.search returns host arrays) are read back too
    assert profiling.timed_device_fn(lambda: (np.zeros(2), np.ones(2)), iters=1)["iters"] == 1


def test_timed_device_fn_waits_for_the_result():
    def slow():
        time.sleep(0.02)
        return torch.zeros(1)

    assert profiling.timed_device_fn(slow, iters=2, warmup=0)["mean_s"] >= 0.02


def test_timer_and_phase_timer_match_jax(caplog):
    got, want = timing.Timer(), ref_timing.Timer()
    for t in (got, want):
        for name in ("encode", "search", "encode"):
            with t.phase(name):
                pass
    assert {k: v["count"] for k, v in got.summary().items()} == {k: v["count"] for k, v in want.summary().items()}
    assert set(got.summary()["encode"]) == {"total_s", "count"}
    with pytest.raises(KeyError):
        with got.phase("failing"):
            raise KeyError("x")
    assert got.counts["failing"] == 1  # a phase that raises is still counted
    log = logging.getLogger("cdr-test-timing")
    with caplog.at_level(logging.INFO, logger="cdr-test-timing"):
        with timing.phase_timer("load", logger=log):
            pass
    assert any(r.getMessage().startswith("load took ") for r in caplog.records)
