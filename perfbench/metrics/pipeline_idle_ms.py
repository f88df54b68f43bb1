"""Ms a batch that the card sat idle inside the program's
``seismic.search`` range, over the profiled stretch: the host holding
the card back inside the pipeline, apart from the benchmark's loop
between calls (``perfbench/spans.py``)."""
from perfbench import spans

LAYER = "entry"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "qps"


def collect(ctx):
    split = spans.stretch_split(ctx)
    return split.pipeline_idle_ms() if split else None


def read(rec):
    return rec.collected.get("pipeline_idle_ms")
