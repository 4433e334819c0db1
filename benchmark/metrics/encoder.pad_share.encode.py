"""``encoder.pad_share.encode``: the share of the forwards' token slots that
hold padding, ``1 - encoder.tokens / encoder.padded_tokens`` of the port's
counters (``models/encoder.py``: each batch's mask sum against its rows x
bucket length, counted where it is tokenized). Read from
``codemix_dense_retrieval_torch.utils.timing.totals()``, which records only
while the window is profiled; none where the port has no such counters.
Moves ``encode_passages_per_s``."""

LAYER = "encoder"


def read(r):
    if r.trace is None:
        return None
    try:
        from codemix_dense_retrieval_torch.utils import timing

        counters = timing.totals()["counters"]
    except (ImportError, AttributeError):   # a port without counters
        return None
    slots = counters.get("encoder.padded_tokens")
    if not slots:
        return None
    return 100.0 * (1.0 - counters.get("encoder.tokens", 0) / slots)
