"""Device ms a batch launched inside the program's ``seismic.refine``
range (the kNN-graph rounds, ``refine_round``), over the profiled
stretch, each kernel, copy and memset put down to the range that holds
its launch (``perfbench/spans.py``); nothing where refine is the
identity."""
from perfbench import spans

LAYER = "graph/refine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "qps"


def collect(ctx):
    p = ctx.params
    if p.refine_rounds <= 0 or p.graph_degree <= 0:
        return None
    split = spans.stretch_split(ctx)
    return split.stage_ms("refine") if split else None


def read(rec):
    return rec.collected.get("refine_device_ms")
