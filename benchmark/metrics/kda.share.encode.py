"""``kda.share.encode``: the card's seconds in Kimi Delta Attention blocks
(the port's span ``kda.attention`` in ``models/kimi_linear.py``: the
projections, short convolutions, gates, the scan and the gated output
norm, timed by CUDA events on the stream from its first queued work to its
last; off a card, the span's own seconds) as a share of the window. Read
from ``codemix_dense_retrieval_torch.utils.timing.totals()``, which records
only while the window is profiled; none where the port has no such span.
Moves ``encode_passages_per_s``."""

LAYER = "encoder"
SPAN = "kda.attention"


def read(r):
    if r.trace is None or r.window_s <= 0:
        return None
    try:
        from codemix_dense_retrieval_torch.utils import timing

        spans = timing.totals()["spans"]
    except (ImportError, AttributeError):   # a port without spans
        return None
    s = spans.get(SPAN)
    if not s:
        return None
    secs = s["seconds"] if s["device_seconds"] is None else s["device_seconds"]
    return 100.0 * secs / r.window_s
