"""``device.idle_share.sweep``: the share of the traced window in which no
kernel, copy or set ran on the card (``1 - busy_s / window_s`` of the
trace). Moves ``sweep_qps``."""

LAYER = "device"


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
