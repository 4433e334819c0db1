"""``trec.marshal_share.sweep``: the seconds of the port's span
``trec.marshal`` (``io/_fastio.py::write_run``: the qid and docid columns
joined into newline-separated buffers, encoded and checked, before the
native write) as a share of the window. Read from
``codemix_dense_retrieval_torch.utils.timing.totals()``, which records only
while the window is profiled; none where the port has no such span.
Moves ``sweep_qps``."""

LAYER = "runner and host IO"
SPAN = "trec.marshal"


def read(r):
    if r.trace is None or r.window_s <= 0:
        return None
    try:
        from codemix_dense_retrieval_torch.utils import timing

        span = timing.totals()["spans"].get(SPAN)
    except (ImportError, AttributeError):   # a port without spans
        return None
    if not span:
        return None
    return 100.0 * span["seconds"] / r.window_s
