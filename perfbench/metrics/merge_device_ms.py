"""Device ms a batch launched inside the program's ``seismic.merge`` range
(the top-k of the scored candidates), over the profiled stretch, each
kernel, copy and memset put down to the range that holds its launch
(``perfbench/spans.py``)."""
from perfbench import spans

LAYER = "retrieval/merge"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "qps"


def collect(ctx):
    split = spans.stretch_split(ctx)
    return split.stage_ms("merge") if split else None


def read(rec):
    return rec.collected.get("merge_device_ms")
