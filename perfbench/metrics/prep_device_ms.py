"""Device ms a batch launched inside the program's ``seismic.prep`` range
(the queries' copy to the card and their dense rows), over the profiled
stretch, each kernel, copy and memset put down to the range that holds
its launch (``perfbench/spans.py``)."""
from perfbench import spans

LAYER = "retrieval/prep"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "qps"


def collect(ctx):
    split = spans.stretch_split(ctx)
    return split.stage_ms("prep") if split else None


def read(rec):
    return rec.collected.get("prep_device_ms")
