"""Profiling hooks: ``torch.profiler`` traces gated by ``CDR_PROFILE_DIR``,
and a device timer that waits for the card (the port of the JAX package's
``utils/profiling.py``)."""

from __future__ import annotations

import contextlib
import os
import pathlib
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def maybe_trace(name: str, trace_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (CPU activity, and CUDA activity
    when a card is present) into ``<dir>/<name>/trace.json``, a Chrome
    trace (chrome://tracing, Perfetto), when ``trace_dir`` or
    ``CDR_PROFILE_DIR`` is set; otherwise a no-op."""
    target = trace_dir or os.environ.get("CDR_PROFILE_DIR")
    if not target:
        yield
        return
    out = pathlib.Path(target) / name
    out.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


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
