"""``encoder.launch_share.encode``: the host seconds of the port's span
``encoder.forward`` (``models/encoder.py::TextEncoder._forward``: the
forward's dispatch on the main thread, which returns once every kernel is
queued) as a share of the window. Read from
``codemix_dense_retrieval_torch.utils.timing.totals()``, which records only
while the window is profiled; none where the port has no such span.
Moves ``encode_passages_per_s``.

Two biases, both upward: the profiler adds its own cost to each aten op
the forward dispatches, so the traced window runs slower than an untraced
one; and a launch that finds the card's queue full blocks inside the span,
so a forward that waits for the card reads as dispatch. A share at or
above the card's busy share shows the main thread is never free, not by
itself that launches are the bottleneck: the untraced
``last_phase_stats`` (``job_iter`` less ``tokenize_wait``) and the
dispatch time of a forward with the queue empty against its device time
tell the two apart."""

LAYER = "encoder"
SPAN = "encoder.forward"


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
