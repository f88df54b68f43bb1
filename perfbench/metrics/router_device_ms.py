"""Device ms a batch launched inside the program's ``seismic.router`` range
(``router_flat`` or ``router_hier`` and what surrounds it), over the
profiled stretch, each kernel, copy and memset put down to the range
that holds its launch (``perfbench/spans.py``)."""
from perfbench import spans

LAYER = "retrieval/router"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "qps"


def collect(ctx):
    split = spans.stretch_split(ctx)
    return split.stage_ms("router") if split else None


def read(rec):
    return rec.collected.get("router_device_ms")
