"""``search.tail_share.sweep``: the card's seconds inside the port's span
``search.tail`` (``ops/topk.py``: the top-k tail after each query chunk's
phase 1, timed by CUDA events on the stream around it) as a share of the
window. Read from ``codemix_dense_retrieval_torch.utils.timing.totals()``,
which records only while the window is profiled; none off the card (no
device seconds) or where the port has no such span. Moves ``sweep_qps``."""

LAYER = "search"
SPAN = "search.tail"


def read(r):
    if r.trace is None or r.window_s <= 0:
        return None
    try:
        from codemix_dense_retrieval_torch.utils import timing

        span = timing.totals()["spans"].get(SPAN)
    except (ImportError, AttributeError):   # a port without spans
        return None
    if not span or span.get("device_seconds") is None:
        return None
    return 100.0 * span["device_seconds"] / r.window_s
