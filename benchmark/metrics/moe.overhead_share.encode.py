"""``moe.overhead_share.encode``: the card's seconds in a mixture of
experts' routing, dispatch and combine (the port's spans ``moe.route``,
``moe.dispatch``, ``moe.combine`` in ``models/moe.py``, each timed by CUDA
events on the stream: from its first queued work to its last; off a card,
where the work runs inside the call, the spans' own seconds) as a share
of the window: the bandwidth- and launch-bound work around the grouped
expert products. Read from
``codemix_dense_retrieval_torch.utils.timing.totals()``, which records only
while the window is profiled; none where the port has no such spans.
Moves ``encode_passages_per_s``."""

LAYER = "experts"
SPANS = ("moe.route", "moe.dispatch", "moe.combine")


def read(r):
    if r.trace is None or r.window_s <= 0:
        return None
    try:
        from codemix_dense_retrieval_torch.utils import timing

        spans = timing.totals()["spans"]
    except (ImportError, AttributeError):   # a port without spans
        return None
    found = [spans[n] for n in SPANS if n in spans]
    if not found:
        return None
    secs = sum(s["seconds"] if s["device_seconds"] is None else s["device_seconds"] for s in found)
    return 100.0 * secs / r.window_s
