"""Profiling hooks: ``torch.profiler`` traces gated by ``CDR_PROFILE_DIR``,
with the port's spans, and a device timer that waits for the card (the
port of the JAX package's ``utils/profiling.py``)."""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import time
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from codemix_dense_retrieval_torch.utils import timing


@contextlib.contextmanager
def maybe_trace(name: str, trace_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (CPU activity, and CUDA activity
    when a card is present) into ``<dir>/<name>/trace.json``, a Chrome
    trace (chrome://tracing, Perfetto), when ``trace_dir`` or
    ``CDR_PROFILE_DIR`` is set; otherwise a no-op.

    The port's spans (:mod:`~codemix_dense_retrieval_torch.utils.timing`,
    reset on entry) go into the trace as well, one row per thread (the
    encoder's prefetch and reader threads included, which the profiler
    does not record), and their ``timing.totals()`` into ``spans.json``
    beside it."""
    target = trace_dir or os.environ.get("CDR_PROFILE_DIR")
    if not target:
        yield
        return
    out = pathlib.Path(target) / name
    out.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    timing.reset()
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
    _add_span_rows(out / "trace.json", timing.records())
    (out / "spans.json").write_text(json.dumps(timing.totals(), indent=1))


#: thread ids of the span rows, above any OS thread id
_SPAN_TID_BASE = 1 << 40


def _add_span_rows(path: pathlib.Path, records: Sequence[timing.Record]) -> None:
    """Add span records to an exported Chrome trace as complete events, one
    row per recording thread (named ``spans: <thread>``), on the trace's
    time base: its ``ts`` are microseconds after ``baseTimeNanoseconds``
    (0 where the trace has none), and the spans' ``time.time_ns()`` stamps
    are the clock of its host events."""
    trace = json.loads(path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    tids: Dict[str, int] = {}
    events = trace["traceEvents"]
    for r in records:
        if r.thread not in tids:
            tids[r.thread] = _SPAN_TID_BASE + len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tids[r.thread],
                           "args": {"name": f"spans: {r.thread}"}})
        events.append({"ph": "X", "cat": "span", "name": r.name, "pid": pid, "tid": tids[r.thread],
                       "ts": (r.start_ns - base) / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
                       "args": {"parent": r.parent}})
    path.write_text(json.dumps(trace))


def _first_leaf(r):
    if isinstance(r, (tuple, list)):
        return _first_leaf(r[0])
    if isinstance(r, dict):
        return _first_leaf(next(iter(r.values())))
    return r


def _wait(r) -> None:
    """Wait for ``r``: synchronize its card, then read one element on the
    host (a launch returns before the card finishes, so a host clock alone
    would time the enqueue)."""
    leaf = _first_leaf(r)
    if isinstance(leaf, torch.Tensor):
        if leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
        leaf.reshape(-1)[0].item()
    else:
        float(np.asarray(leaf).ravel()[0])


def timed_device_fn(fn, *args, iters: int = 5, warmup: int = 1) -> Dict[str, float]:
    """Mean wall seconds of ``fn(*args)`` after ``warmup`` calls, each call
    waited for on the card and read back on the host."""
    for _ in range(warmup):
        _wait(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        _wait(fn(*args))
    dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "iters": iters}
