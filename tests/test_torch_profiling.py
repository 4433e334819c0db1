"""utils/profiling.py against the JAX package's: maybe_trace as a no-op and
with a CPU trace (a Chrome trace under <dir>/<name>/, with the port's spans
on rows of their own and their totals in spans.json), and timed_device_fn's
result and its wait on the result."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.utils import profiling, timing
from codemix_dense_retrieval_tpu.utils import profiling as ref_profiling


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
        with timing.span("marked_span"):
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


def test_maybe_trace_writes_spans_json_and_the_helper_threads_rows(tmp_path):
    timing.reset()
    with timing.span("before"):   # no profiler yet: not recorded
        pass

    def work(handed):
        with timing.span("helper.step", within=handed):
            time.sleep(0.002)

    with profiling.maybe_trace("enc", str(tmp_path)):
        with timing.span("caller"):
            handed = timing.handoff()
            th = threading.Thread(target=work, args=(handed,), name="helper-1")
            th.start()
            th.join(timeout=30)
        timing.count("items", 5)
    assert not th.is_alive()
    spans = json.loads((tmp_path / "enc" / "spans.json").read_text())
    assert spans == json.loads(json.dumps(timing.totals()))
    assert set(spans["spans"]) == {"caller", "helper.step"} and spans["counters"] == {"items": 5}
    assert spans["spans"]["helper.step"]["parent"] == "caller"
    trace = json.loads((tmp_path / "enc" / "trace.json").read_text())
    base = trace.get("baseTimeNanoseconds", 0)
    rows = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
            if e.get("ph") == "M" and e.get("name") == "thread_name"}
    ours = {e["name"]: e for e in trace["traceEvents"] if e.get("cat") == "span"}
    assert rows[ours["helper.step"]["tid"]] == "spans: helper-1"
    assert rows[ours["caller"]["tid"]] == "spans: MainThread"
    # the helper's row lies inside the caller's host event, on the trace's time base
    host, = [e for e in trace["traceEvents"] if e.get("cat") == "user_annotation" and e["name"] == "caller"]
    step = ours["helper.step"]
    assert host["ts"] <= step["ts"] and step["ts"] + step["dur"] <= host["ts"] + host["dur"]
    rec, = [r for r in timing.records() if r.name == "helper.step"]
    assert step["ts"] == pytest.approx((rec.start_ns - base) / 1e3, rel=0, abs=1e-3)
