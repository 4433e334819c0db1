"""The traced window: ``torch.profiler`` over CPU and CUDA activity, reduced
to what the per-layer metrics and the ``breakdown`` read.

- busy seconds: the union of the device's kernel, copy and set intervals
  inside the window (``busy_s``); the window's length (``window_s``);
- device time and launch count per kernel name;
- the idle gaps between device intervals, each put down to the innermost
  host operation or span that was open at its middle.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

WINDOW_SPAN = "bench.window"
SMALL_GAP_NS = 20_000          # gaps below this are summed under one name
BACKWARD_SCAN = 4000           # host events looked at for a gap's owner
NAME_CHARS = 160


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]]          # name -> (launches, device seconds)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_time(self, fragment: str) -> Tuple[int, float]:
        n = s = 0
        for name, (c, t) in self.kernels.items():
            if fragment in name:
                n, s = n + c, s + t
        return n, s

    def device_ops(self, top: int = 10) -> List[list]:
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        return [[name[:NAME_CHARS], secs] for name, (_, secs) in rows]


class Tracer:
    """``with Tracer() as t:`` profiles the block; ``t.summary()`` reduces it."""

    def __init__(self) -> None:
        self.prof = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def summary(self) -> TraceSummary:
        t0 = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        win: Optional[Tuple[int, int]] = None
        host: List[Tuple[int, int, str]] = []
        dev: List[Tuple[int, int, str]] = []
        for e in events:
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    dev.append((start, start + dur, e.name()))
            else:
                name = e.name()
                if name == WINDOW_SPAN:
                    win = (start, start + dur)
                host.append((start, start + dur, name))
        if win is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
        w0, w1 = win
        # a device span as long as most of the window is an annotation, not work
        dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev
               if b > w0 and a < w1 and (b - a) < 0.5 * (w1 - w0)]
        kernels: Dict[str, list] = defaultdict(lambda: [0, 0.0])
        for a, b, n in dev:
            kernels[n][0] += 1
            kernels[n][1] += (b - a) * 1e-9
        busy, gaps = _union(sorted((a, b) for a, b, _ in dev), w0, w1)
        summary = TraceSummary(
            window_s=(w1 - w0) * 1e-9,
            busy_s=busy * 1e-9,
            kernels={k: (v[0], v[1]) for k, v in kernels.items()},
            idle_gaps=_owners(gaps, host),
        )
        summary.reduce_s = time.perf_counter() - t0
        return summary


def _union(intervals: List[Tuple[int, int]], w0: int, w1: int):
    """(covered ns, gaps [(start, end)]) of sorted intervals inside [w0, w1]."""
    covered, gaps, end = 0, [], w0
    for a, b in intervals:
        if a > end:
            gaps.append((end, a))
        if b > end:
            covered += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))
    return covered, gaps


def _owners(gaps: List[Tuple[int, int]], host: List[Tuple[int, int, str]], top: int = 10) -> List[list]:
    """Idle seconds per name of the innermost host event open at each gap's
    middle (the latest-starting one that contains it), largest first."""
    host.sort()
    starts = [h[0] for h in host]
    total: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        if b - a < SMALL_GAP_NS:
            total[f"(gaps under {SMALL_GAP_NS // 1000} us)"] += (b - a) * 1e-9
            continue
        mid = (a + b) // 2
        owner = "(no host event)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - BACKWARD_SCAN), -1):
            if host[j][1] > mid and host[j][2] != WINDOW_SPAN:
                owner = host[j][2]
                break
        total[owner[:NAME_CHARS]] += (b - a) * 1e-9
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]
