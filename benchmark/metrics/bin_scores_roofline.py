"""``bin_scores_roofline``: kernel A's share of its roofline in the sweep.

The least time of the window's bin-score launches over their device time
(the trace's kernels whose name holds ``bin_scores``). Each launch is
counted as one block of the padded query rows the window searched, split
evenly over the launches; its least time is the larger of its bytes over
3.35 TB/s and its 2 * B * N * d operations over 989 TFLOP/s. Bytes count
the index rows read once (N * d * 2), the block's queries once (B * d * 2)
and the bin maxima written once (B * N / G * 4, G = 8 rows a bin), not the
f32 score store, so the count is the same whatever implements the work.
Moves ``sweep_qps``."""

from harness.peaks import bound

LAYER = "kernels"
BIN_ROWS = 8


def least_seconds(launches: int, queries: int, rows: int, dim: int) -> float:
    b = queries / launches
    nbytes = rows * dim * 2 + b * dim * 2 + b * rows / BIN_ROWS * 4
    return launches * bound(nbytes, 2.0 * b * rows * dim)[0]


def read(r):
    if r.trace is None:
        return None
    launches, secs = r.trace.kernel_time("bin_scores")
    c = r.counters
    if not launches or secs <= 0 or not c.get("padded_queries"):
        return None
    return 100.0 * least_seconds(launches, c["padded_queries"], c["rows"], c["dim"]) / secs
