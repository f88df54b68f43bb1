"""Host waits on the card a batch inside the program's ``seismic.search``
range, over the profiled stretch: stream, device and event synchronizes
and synchronous copies and memsets (``perfbench/spans.py``). A CUDA
graph per batch needs it at zero."""
from perfbench import spans

LAYER = "entry"
UNIT = "syncs"
SOURCE = "device_trace"
MOVES = "qps"


def collect(ctx):
    split = spans.stretch_split(ctx)
    return split.syncs / split.calls if split else None


def read(rec):
    return rec.collected.get("syncs_per_batch")
