"""Wall-clock phase timers (the port of the JAX package's
``utils/timing.py``); ``phase_timer(trace=True)`` also labels the span in a
``torch.profiler`` trace."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator


class Timer:
    """Accumulating named-phase timer."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"total_s": self.totals[name], "count": self.counts[name]}
            for name in self.totals
        }


@contextlib.contextmanager
def phase_timer(name: str, logger=None, trace: bool = False) -> Iterator[None]:
    """Time one phase (logged at INFO when ``logger`` is given); with
    ``trace`` it is a ``torch.profiler.record_function`` span."""
    ctx = contextlib.nullcontext()
    if trace:
        import torch

        ctx = torch.profiler.record_function(name)
    t0 = time.perf_counter()
    with ctx:
        yield
    if logger is not None:
        logger.info("%s took %.3fs", name, time.perf_counter() - t0)
