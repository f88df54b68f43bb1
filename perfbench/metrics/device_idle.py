"""Share of the profiled stretch (one call of each distinct batch) in
which no kernel, copy or memset ran on the card."""
LAYER = "device"
UNIT = "share"
SOURCE = "device_trace"
MOVES = "qps"


def read(rec):
    t = rec.device_trace
    if t is None or t.window_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
