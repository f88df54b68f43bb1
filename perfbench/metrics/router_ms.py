"""Milliseconds of the router stage a batch (``retrieval/router``), as
``run_pipeline_staged(record=...)`` times it up to a synchronize, over
the traced run's window."""
LAYER = "retrieval/router"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "qps"


def read(rec):
    t = rec.stage_s.get("router")
    return 1e3 * sum(t) / len(t) if t else None
