"""Seismic query processing entry point (re-exports the pipeline)."""
from __future__ import annotations

from repro_torch.retrieval.params import SearchParams
from repro_torch.retrieval.pipeline import run_pipeline, search_pipeline
from repro_torch.retrieval.router import NEG
from repro_torch.sparse.ops import PaddedSparse


def search_batch(index, queries: PaddedSparse, p: SearchParams):
    """Batched Seismic search (the shared retrieval pipeline).

    Returns (scores [Q,k], ids [Q,k] with -1 padding, docs_evaluated [Q])."""
    return search_pipeline(index, queries, p)


__all__ = ["SearchParams", "search_batch", "search_pipeline",
           "run_pipeline", "NEG"]
