"""Device ms a batch launched inside the program's ``seismic.selector``
range (the adaptive selector's probe scoring included), over the
profiled stretch, each kernel, copy and memset put down to the range
that holds its launch (``perfbench/spans.py``)."""
from perfbench import spans

LAYER = "retrieval/selector"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "qps"


def collect(ctx):
    split = spans.stretch_split(ctx)
    return split.stage_ms("selector") if split else None


def read(rec):
    return rec.collected.get("selector_device_ms")
