"""Recall@k of the window's answers to a sample of pool queries drawn
from the seed, against the exact top-k the plain reference computes over
the whole collection after the window."""
LAYER = "entry"
UNIT = "share"
SOURCE = "host_clock"
MOVES = "recall_at_k"


def read(rec):
    return rec.values.get("recall_at_k")
