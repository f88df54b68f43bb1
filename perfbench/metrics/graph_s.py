"""Seconds of ``graph/build.build_doc_graph`` on the built index, host
clock to a synchronize; nothing in a cell without a graph."""
LAYER = "builders"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(rec):
    return rec.values.get("graph_s")
