"""``tokenizer.wait_share.encode``: the share of the encoder's wall that its
main thread spent waiting for the tokenizer's prefetch thread: the sum of
``tokenize_wait`` over the sum of ``wall`` of ``TextEncoder.last_phase_stats``
over the window's ``encode_documents`` calls. Moves ``encode_passages_per_s``."""

LAYER = "host tokenizer"


def read(r):
    calls = r.counters.get("phase_stats") or []
    wall = sum(c.get("wall", 0.0) for c in calls)
    if wall <= 0:
        return None
    return 100.0 * sum(c.get("tokenize_wait", 0.0) for c in calls) / wall
