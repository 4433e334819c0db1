"""``trec.write_share.sweep``: seconds inside ``write_run`` (as
``pipeline.runs`` calls it, timed by the driver) as a share of the window.
Moves ``sweep_qps``."""

LAYER = "runner and host IO"


def read(r):
    w = r.counters.get("write_s")
    if w is None or r.window_s <= 0:
        return None
    return 100.0 * w / r.window_s
