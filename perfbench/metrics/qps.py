"""Queries answered in the window over the window's seconds; a query
counts once its ids and scores are on the host. The window ends when the
call that crosses its length returns."""
LAYER = "entry"
UNIT = "queries/s"
SOURCE = "host_clock"
MOVES = "qps"


def read(rec):
    return rec.requests / rec.window_s
