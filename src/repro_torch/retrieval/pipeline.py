"""Pipeline orchestration: prep -> router -> selector -> scorer -> merge
-> refine (port of ``repro.retrieval.pipeline``).

``run_pipeline`` is the batch-first core; ``search_pipeline`` its front
door on a ``PaddedSparse`` batch. ``stage_fns`` / ``run_pipeline_staged``
run the same stages one at a time with a device synchronize between
them, for per-stage wall time. Refine (kNN-graph expansion) is not
ported: the stage is the identity, as in the JAX package with
``graph_degree`` or ``refine_rounds`` at 0. Settings the port does not
cover raise ``NotImplementedError`` (:func:`validate_params`).
"""
from __future__ import annotations

import time
from typing import TYPE_CHECKING, Callable

import torch

from repro_torch.retrieval.merge import merge_topk
from repro_torch.retrieval.params import SearchParams
from repro_torch.retrieval.prep import prep_queries
from repro_torch.retrieval.router import route_batch
from repro_torch.retrieval.scorer import score_selection
from repro_torch.retrieval.selector import get_selector
from repro_torch.sparse.ops import PaddedSparse

if TYPE_CHECKING:
    from repro_torch.core.types import SeismicIndex


def validate_params(index: "SeismicIndex", p: SearchParams) -> None:
    """Raise ``NotImplementedError`` for what this port does not cover
    yet, naming its ROADMAP item, instead of silently degrading."""
    if p.fuse_level >= 2:
        raise NotImplementedError(
            "fuse_level=2 needs the fused router and refine kernels, not "
            "ported yet (ROADMAP Queue 1, kernels d, e and f)")
    if p.superblock_fanout > 0 or index.sup_coords is not None:
        raise NotImplementedError(
            "hierarchical routing and the superblock tier are not ported "
            "yet (ROADMAP Queue 1, hierarchical routing and the superblock "
            "build)")
    if (p.graph_degree > 0 and p.refine_rounds > 0) \
            or index.knn_ids is not None:
        raise NotImplementedError(
            "kNN-graph refinement is not ported yet (ROADMAP Queue 1, "
            "graph refine)")


def run_pipeline(index: "SeismicIndex", q_coords: torch.Tensor,
                 q_vals: torch.Tensor, p: SearchParams
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched staged search over padded-sparse queries [Q, nnz].

    Returns (scores [Q, k], ids int32 [Q, k] with -1 padding,
    docs_evaluated int32 [Q]); the queries move to the index's device."""
    validate_params(index, p)
    select = get_selector(p.policy)
    q_dense, lists, _ = prep_queries(q_coords.to(index.device),
                                     q_vals.to(index.device), index.dim,
                                     p.cut)
    batch = route_batch(index, q_dense, lists, p)
    sel = select(index, batch, p)
    cand, scores = score_selection(index, batch, sel, p.use_kernel,
                                   fuse_level=p.fuse_level)
    return merge_topk(cand, scores, p.k, index.n_docs)


def search_pipeline(index: "SeismicIndex", queries: PaddedSparse,
                    p: SearchParams):
    """Batched Seismic search; runs where the index lives.

    Returns (scores [Q,k], ids [Q,k] with -1 padding, docs_evaluated [Q])."""
    return run_pipeline(index, queries.coords, queries.vals, p)


STAGES = ("prep", "router", "selector", "scorer", "merge", "refine")


def stage_fns(index: "SeismicIndex", p: SearchParams
              ) -> dict[str, Callable]:
    """Stage functions (index and params closed over), keyed by
    ``STAGES`` name."""
    validate_params(index, p)
    select = get_selector(p.policy)
    return {
        "prep": lambda c, v: prep_queries(c, v, index.dim, p.cut),
        "router": lambda qd, ls: route_batch(index, qd, ls, p),
        "selector": lambda b: select(index, b, p),
        "scorer": lambda b, s: score_selection(index, b, s, p.use_kernel,
                                               fuse_level=p.fuse_level),
        "merge": lambda c, s: merge_topk(c, s, p.k, index.n_docs),
        "refine": lambda qd, s, i, e: (s, i, e),
    }


def run_pipeline_staged(index: "SeismicIndex", q_coords: torch.Tensor,
                        q_vals: torch.Tensor, p: SearchParams,
                        record: Callable[[str, float], None] | None = None,
                        span_cb: Callable[[str, float, float], None]
                        | None = None,
                        probe: Callable[[str, object], None] | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage-by-stage pipeline with per-stage wall-time reporting.

    ``record(stage, seconds)`` gets each stage's wall time, measured up
    to a device synchronize; ``span_cb(stage, t0, t1)`` the
    ``time.monotonic`` stamps. ``probe(name, value)`` sees the scorer's
    candidate ids (``"cand"``), the probed ``lists``, the router scores
    ``router_r`` and the merged ``merge_ids``. Output matches
    :func:`search_pipeline`."""
    fns = stage_fns(index, p)
    cuda = index.device.type == "cuda"

    def timed(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize(index.device)
        t1 = time.monotonic()
        if record is not None:
            record(name, t1 - t0)
        if span_cb is not None:
            span_cb(name, t0, t1)
        return out

    q_dense, lists, _ = timed("prep", fns["prep"], q_coords.to(index.device),
                              q_vals.to(index.device))
    batch = timed("router", fns["router"], q_dense, lists)
    sel = timed("selector", fns["selector"], batch)
    cand, scores = timed("scorer", fns["scorer"], batch, sel)
    if probe is not None:
        probe("cand", cand)
        probe("lists", lists)
        probe("router_r", batch.r)
    top_s, top_ids, ev = timed("merge", fns["merge"], cand, scores)
    if probe is not None:
        probe("merge_ids", top_ids)
    return timed("refine", fns["refine"], q_dense, top_s, top_ids, ev)
