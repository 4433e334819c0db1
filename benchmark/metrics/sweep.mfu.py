"""``sweep.mfu``: the alpha sweep's whole step as a share of the chip's bf16
peak: every search of the window (one query pair at one alpha) counted as
the exact scan's 2 * N * d operations, over the window's seconds times
989 TFLOP/s. Moves ``sweep_qps``."""

from harness.peaks import BF16_FLOPS

LAYER = "search"


def flops(searches: int, rows: int, dim: int) -> float:
    return 2.0 * searches * rows * dim


def read(r):
    c = r.counters
    if not c.get("searches") or r.window_s <= 0:
        return None
    return 100.0 * flops(c["searches"], c["rows"], c["dim"]) / (r.window_s * BF16_FLOPS)
