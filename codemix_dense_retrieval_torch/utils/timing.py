"""The port's spans and counters, recorded only while a ``torch.profiler``
session records.

``with span(name):`` marks one batch-level step of a layer (a search call,
a query block, a file write, a forward, a mixture-of-experts layer's
routing or its grouped products), never a single kernel launch. Tracing
is on for a span when a profiler records on the thread that opens it;
work handed to a helper thread carries the caller's decision and
its innermost span as ``within=handoff()``, since a profiler records only
the thread that started it. With tracing off ``span`` returns one shared
no-op context after one flag check, and ``count`` returns at once.

With tracing on a span

- opens ``torch.profiler.record_function(name)`` on a profiled thread, so
  it is a host event of the device trace;
- keeps one record ``(name, parent, thread, start_ns, end_ns)``: the start
  is stamped by ``time.time_ns()``, the clock of the trace's host events,
  so a helper thread's span can be laid on the device timeline; the
  duration (and so the end) is read from ``time.perf_counter_ns()``, which
  no clock adjustment steps;
- adds to its name's count, seconds and self seconds (seconds less those
  of child spans on the same thread);
- with ``device`` a CUDA device, records two timing events on that
  device's current stream around the body: ``totals()`` gives the stream's
  seconds between them as ``device_seconds`` (None elsewhere): the card's
  time from the span's first queued work to its last, idle gaps between
  its launches included.

The registry holds what was recorded since the last ``reset()``:
``utils.profiling.maybe_trace`` resets it on entry, and a process that
profiles one window reads exactly that window. Records and totals are
guarded by one lock, taken only while tracing is on.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch


class Record(NamedTuple):
    name: str
    parent: Optional[str]
    thread: str
    start_ns: int
    end_ns: int


class Handoff(NamedTuple):
    """The caller's decision (tracing on) and its innermost open span, for
    the spans and counts of work it hands to a helper thread."""
    parent: Optional[str]


_LOCK = threading.Lock()
_LOCAL = threading.local()          # .stack: this thread's open spans
_RECORDS: List[Record] = []
_SPANS: Dict[str, dict] = {}
_COUNTERS: Dict[str, int] = {}
_DEVICE_COUNTERS: Dict[str, torch.Tensor] = {}


class _Off:
    """The shared context of a span while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Stat:
    """Tracing off, a phase counter to feed: the body's seconds on the
    clock a span's duration reads."""

    __slots__ = ("stat", "t0")

    def __init__(self, stat: Tuple[dict, str]) -> None:
        self.stat = stat

    def __enter__(self) -> None:
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        d, key = self.stat
        d[key] += (time.perf_counter_ns() - self.t0) * 1e-9
        return False


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Span:
    __slots__ = ("name", "device", "parent", "stat", "rf", "events", "start_ns", "t0", "child_ns")

    def __init__(self, name: str, device, within: Optional[Handoff], stat, profiled: bool) -> None:
        self.name, self.stat = name, stat
        self.device = device if device is not None and torch.device(device).type == "cuda" else None
        stack = _stack()
        self.parent = stack[-1].name if stack else (within.parent if within is not None else None)
        self.rf = torch.profiler.record_function(name) if profiled else None
        self.events = None
        self.child_ns = 0

    def __enter__(self) -> "_Span":
        _stack().append(self)
        if self.rf is not None:
            self.rf.__enter__()
        if self.device is not None:
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
        self.start_ns = time.time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter_ns() - self.t0
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += dur
        if self.stat is not None and self.stat[0] is not None:
            self.stat[0][self.stat[1]] += dur * 1e-9
        rec = Record(self.name, self.parent, threading.current_thread().name,
                     self.start_ns, self.start_ns + dur)
        with _LOCK:
            _RECORDS.append(rec)
            t = _SPANS.get(self.name)
            if t is None:
                t = _SPANS[self.name] = {"count": 0, "seconds": 0.0, "self_seconds": 0.0,
                                         "parent": self.parent, "device_seconds": None, "pending": []}
            t["count"] += 1
            t["seconds"] += dur * 1e-9
            t["self_seconds"] += (dur - self.child_ns) * 1e-9
            if self.events is not None:
                t["pending"].append(self.events)
        return False


def span(name: str, *, device=None, within: Optional[Handoff] = None,
         stat: Optional[Tuple[Optional[dict], str]] = None):
    """A span of the layer step ``name`` (see the module docstring).

    ``device``: a device whose current stream the span also times, when
    it is a CUDA device. ``within``: on a helper thread, the caller's
    ``handoff()``. ``stat``: ``(phase counter dict or None, key)``: the
    body's seconds are also added to ``dict[key]``, with tracing on or off,
    from the span's own clock readings."""
    profiled = torch.autograd._profiler_enabled()
    if not profiled and within is None:
        return _OFF if stat is None or stat[0] is None else _Stat(stat)
    return _Span(name, device, within, stat, profiled)


def tracing() -> bool:
    """Whether a profiler records on this thread, so that spans and counts
    opened here without ``within`` record."""
    return torch.autograd._profiler_enabled()


def handoff() -> Optional[Handoff]:
    """The caller's decision and innermost open span, for ``within=`` on a
    helper thread; None while tracing is off."""
    if not tracing():
        return None
    stack = getattr(_LOCAL, "stack", None)
    return Handoff(stack[-1].name if stack else None)


def count(name: str, n: int = 1, *, within: Optional[Handoff] = None) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on (``within``: as
    for :func:`span`)."""
    if within is None and not torch.autograd._profiler_enabled():
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


def count_device(name: str, values: torch.Tensor) -> None:
    """Add ``values`` (a tensor of counts, e.g. a histogram) to the counter
    ``name`` on their own device while tracing is on: nothing is read back
    until :func:`totals` gives the sum as a list."""
    if not torch.autograd._profiler_enabled():
        return
    with _LOCK:
        acc = _DEVICE_COUNTERS.get(name)
        if acc is None:
            _DEVICE_COUNTERS[name] = values.to(torch.int64, copy=True)
        else:
            acc.add_(values)


def _device_seconds(t: dict) -> Optional[float]:
    """A span name's device seconds, its pending event pairs resolved
    first (waiting for each)."""
    pairs = t["pending"]
    if pairs:
        for _, end in pairs:
            end.synchronize()
        secs = sum(a.elapsed_time(b) for a, b in pairs) * 1e-3
        t["device_seconds"] = (t["device_seconds"] or 0.0) + secs
        pairs.clear()
    return t["device_seconds"]


def totals() -> dict:
    """``{"spans": {name: {count, seconds, self_seconds, device_seconds,
    parent}}, "counters": {name: n}}`` since the last :func:`reset`; a
    counter of :func:`count_device` is a list (read from its device)."""
    with _LOCK:
        spans = {
            name: {"count": t["count"], "seconds": t["seconds"], "self_seconds": t["self_seconds"],
                   "device_seconds": _device_seconds(t), "parent": t["parent"]}
            for name, t in _SPANS.items()
        }
        device = {name: acc.tolist() for name, acc in _DEVICE_COUNTERS.items()}
        return {"spans": spans, "counters": {**_COUNTERS, **device}}


def records() -> List[Record]:
    """The span records since the last :func:`reset`, in the order they closed."""
    with _LOCK:
        return list(_RECORDS)


def reset() -> None:
    with _LOCK:
        _RECORDS.clear()
        _SPANS.clear()
        _COUNTERS.clear()
        _DEVICE_COUNTERS.clear()
