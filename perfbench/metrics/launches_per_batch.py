"""Device operations a batch launched inside the program's
``seismic.search`` range, over the profiled stretch: the runtime's
kernel launches and asynchronous copies and memsets
(``perfbench/spans.py``)."""
from perfbench import spans

LAYER = "entry"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "qps"


def collect(ctx):
    split = spans.stretch_split(ctx)
    return split.launches / split.calls if split else None


def read(rec):
    return rec.collected.get("launches_per_batch")
