"""Device ms a batch launched inside the program's ``seismic.scorer`` range
(dedupe, compaction and ``gather_dot_cand``), over the profiled stretch,
each kernel, copy and memset put down to the range that holds its launch
(``perfbench/spans.py``)."""
from perfbench import spans

LAYER = "retrieval/scorer"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "qps"


def collect(ctx):
    split = spans.stretch_split(ctx)
    return split.stage_ms("scorer") if split else None


def read(rec):
    return rec.collected.get("scorer_device_ms")
