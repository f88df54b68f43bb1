"""Pipeline orchestration: prep -> router -> selector -> scorer -> merge
-> refine (port of ``repro.retrieval.pipeline``).

``run_pipeline`` is the batch-first core; ``search_pipeline`` its front
door on a ``PaddedSparse`` batch. ``stage_fns`` / ``run_pipeline_staged``
run the same stages one at a time with a synchronize of the calling
thread's stream between them, for per-stage wall time. The sixth stage
(refine, kNN-graph expansion, ``repro_torch.graph``) is the identity
when ``graph_degree`` or ``refine_rounds`` is 0.
"""
from __future__ import annotations

import time
from typing import TYPE_CHECKING, Callable

import torch

from repro_torch.graph.refine import (refine_batch, refine_one_round,
                                      scored_init, validate_refine_params)
from repro_torch.kernels.runtime import sync_stream
from repro_torch.retrieval.merge import merge_topk
from repro_torch.retrieval.params import SearchParams
from repro_torch.retrieval.prep import prep_queries
from repro_torch.retrieval.router import check_route, route_batch
from repro_torch.retrieval.scorer import score_selection
from repro_torch.retrieval.selector import get_selector
from repro_torch.sparse.ops import PaddedSparse

if TYPE_CHECKING:
    from repro_torch.core.types import SeismicIndex


def validate_params(index: "SeismicIndex", p: SearchParams) -> None:
    """Raise ``ValueError`` before any launch when ``p`` does not fit the
    index: a hierarchical route without a matching superblock tier, or
    graph refinement beyond the index's kNN graph."""
    check_route(index, p)
    validate_refine_params(index, p)


def run_pipeline(index: "SeismicIndex", q_coords: torch.Tensor,
                 q_vals: torch.Tensor, p: SearchParams
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched staged search over padded-sparse queries [Q, nnz].

    Returns (scores [Q, k], ids int32 [Q, k] with -1 padding,
    docs_evaluated int32 [Q]); the queries move to the index's device.
    Params that do not fit the index raise before the first launch."""
    validate_params(index, p)
    select = get_selector(p.policy)
    q_dense, lists, _ = prep_queries(q_coords.to(index.device),
                                     q_vals.to(index.device), index.dim,
                                     p.cut)
    batch = route_batch(index, q_dense, lists, p)
    sel = select(index, batch, p)
    cand, scores = score_selection(index, batch, sel, p.use_kernel,
                                   fuse_level=p.fuse_level)
    top_s, top_ids, ev = merge_topk(cand, scores, p.k, index.n_docs)
    return refine_batch(index, q_dense, top_s, top_ids, ev, p)


def search_pipeline(index: "SeismicIndex", queries: PaddedSparse,
                    p: SearchParams):
    """Batched Seismic search; runs where the index lives.

    Returns (scores [Q,k], ids [Q,k] with -1 padding, docs_evaluated [Q])."""
    return run_pipeline(index, queries.coords, queries.vals, p)


STAGES = ("prep", "router", "selector", "scorer", "merge", "refine")


def stage_fns(index: "SeismicIndex", p: SearchParams
              ) -> dict[str, Callable]:
    """Stage functions (index and params closed over), keyed by
    ``STAGES`` name, plus ``refine_round``: one refine round, for the
    per-round spans of ``run_pipeline_staged(split_refine=True)``."""
    validate_params(index, p)
    select = get_selector(p.policy)
    return {
        "prep": lambda c, v: prep_queries(c, v, index.dim, p.cut),
        "router": lambda qd, ls: route_batch(index, qd, ls, p),
        "selector": lambda b: select(index, b, p),
        "scorer": lambda b, s: score_selection(index, b, s, p.use_kernel,
                                               fuse_level=p.fuse_level),
        "merge": lambda c, s: merge_topk(c, s, p.k, index.n_docs),
        "refine": lambda qd, s, i, e: refine_batch(index, qd, s, i, e, p),
        "refine_round": lambda qd, s, i, e, sc: refine_one_round(
            index, qd, s, i, e, sc, p),
    }


def run_pipeline_staged(index: "SeismicIndex", q_coords: torch.Tensor,
                        q_vals: torch.Tensor, p: SearchParams,
                        fns: dict[str, Callable] | None = None,
                        record: Callable[[str, float], None] | None = None,
                        span_cb: Callable[[str, float, float], None]
                        | None = None,
                        split_refine: bool = False,
                        probe: Callable[[str, object], None] | None = None,
                        audit: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage-by-stage pipeline with per-stage wall-time reporting.

    ``record(stage, seconds)`` gets each stage's wall time, measured up
    to a synchronize of the calling thread's current stream;
    ``span_cb(stage, t0, t1)`` the ``time.monotonic`` stamps. With
    ``split_refine`` the refine stage runs round by round and each round
    is also reported as ``refine_round_<j>`` (inside the ``refine``
    interval), with equal results. ``probe(name, value)`` always sees
    the scorer's candidate ids (``"cand"``); with ``audit`` it also sees
    the shadow auditor's funnel captures: the probed ``lists``, the
    router scores ``router_r`` and the merged ``merge_ids`` (before
    refine). Pass ``fns`` (from :func:`stage_fns`) to reuse one set of
    stage functions across calls. Output matches
    :func:`search_pipeline`."""
    if fns is None:
        fns = stage_fns(index, p)
    dev = index.device

    def timed(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        sync_stream(dev)
        t1 = time.monotonic()
        if record is not None:
            record(name, t1 - t0)
        if span_cb is not None:
            span_cb(name, t0, t1)
        return out

    q_dense, lists, _ = timed("prep", fns["prep"], q_coords.to(dev),
                              q_vals.to(dev))
    batch = timed("router", fns["router"], q_dense, lists)
    sel = timed("selector", fns["selector"], batch)
    cand, scores = timed("scorer", fns["scorer"], batch, sel)
    if probe is not None:
        probe("cand", cand)
        if audit:
            probe("lists", lists)
            probe("router_r", batch.r)
    top_s, top_ids, ev = timed("merge", fns["merge"], cand, scores)
    if audit and probe is not None:
        probe("merge_ids", top_ids)
    if not (split_refine and p.refine_rounds > 0 and p.graph_degree > 0):
        return timed("refine", fns["refine"], q_dense, top_s, top_ids, ev)
    t0 = time.monotonic()
    scored = scored_init(top_ids, index.n_docs)
    s, i, e = top_s, top_ids, ev
    for j in range(p.refine_rounds):
        s, i, e, scored = timed(f"refine_round_{j}", fns["refine_round"],
                                q_dense, s, i, e, scored)
    t1 = time.monotonic()
    if record is not None:
        record("refine", t1 - t0)
    if span_cb is not None:
        span_cb("refine", t0, t1)
    return s, i, e
