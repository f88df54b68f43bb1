"""Milliseconds of the refine stage a batch (``graph/refine``), as
``run_pipeline_staged(record=...)`` times it up to a synchronize, over
the traced run's window; nothing where refine is the identity."""
LAYER = "graph/refine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "qps"


def read(rec):
    t = rec.stage_s.get("refine")
    p = rec.values["params"]
    if not t or p.refine_rounds <= 0 or p.graph_degree <= 0:
        return None
    return 1e3 * sum(t) / len(t)
