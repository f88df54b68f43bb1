"""Mean ``docs_evaluated`` a query over the window (the selector's
output, counted by the pipeline: candidates scored exactly, refine's
rescored neighbours included)."""
import torch

LAYER = "retrieval/selector"
UNIT = "docs/query"
SOURCE = "program_counter"
MOVES = "qps"


def read(rec):
    evaluated = [a[2] for _, a in rec.answers]
    return float(torch.cat(evaluated).double().mean()) if evaluated else None
