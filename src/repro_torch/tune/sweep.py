"""Operating-point sweep (port of ``repro.tune.sweep``): drive a knob
grid through the batched pipeline and measure recall and deterministic
cost per point.

Every grid point runs ``search_pipeline`` (or, with ``timings=True``,
``run_pipeline_staged`` so per-stage wall seconds ride along) over the
whole held-out query batch, where the index lives. The cost model is the
hardware-independent pair the pipeline reports:

  * ``docs_evaluated`` — documents exactly scored per query (scorer
    stage plus every refine round's new frontier), and
  * ``router_work``    — summary inner products per query (closed form).

Wall-clock stage times are advisory only: selection must be
bit-reproducible and invariant to machine load and to the order of the
query sample, so the frontier orders points by the deterministic
(docs_evaluated, router_cost) pair. Per-query recalls are sorted before
the mean is taken (float addition is not associative) and
``docs_evaluated`` sums exact integers.

The grid's ``SearchParams`` take the caller's ``use_kernel`` and
``fuse_level``; those are execution details, so a point measures the same
at every level.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Sequence

import numpy as np

from repro_torch.device import host_array
from repro_torch.obs.quality import per_query_recall
from repro_torch.retrieval.params import SearchParams
from repro_torch.retrieval.pipeline import (run_pipeline_staged,
                                            search_pipeline)
from repro_torch.retrieval.router import router_work

if TYPE_CHECKING:
    from repro_torch.core.types import SeismicIndex
    from repro_torch.sparse.ops import PaddedSparse


@dataclasses.dataclass(frozen=True)
class MeasuredPoint:
    """One swept operating point with its measurements."""

    params: SearchParams
    recall: float                # mean recall@k on the held-out sample
    docs_evaluated: float        # mean docs exactly scored per query
    router_cost: int             # summary dots per query (closed form)
    stage_seconds: tuple = ()    # advisory: (("prep", s), ...) wall time

    @property
    def advisory_seconds(self) -> float | None:
        """Total staged wall seconds for the sample (None when measured
        without timings); reported, never selected on."""
        if not self.stage_seconds:
            return None
        return sum(s for _, s in self.stage_seconds)

    @property
    def cost_key(self) -> tuple:
        """Deterministic total order for frontier and selection: scoring
        work, routing work, then the knob tuple, so exact cost ties break
        reproducibly."""
        return (self.docs_evaluated, self.router_cost,
                dataclasses.astuple(self.params))


def default_grid(index: SeismicIndex, *, k: int = 10, cut: int = 8,
                 use_kernel: bool = True, fuse_level: int = 1
                 ) -> list[SearchParams]:
    """The coupled knob grid for one collection: budgets ladder
    geometrically, each paired with refine rounds when the index carries
    a kNN graph and with the superblock tier when one is built; policy
    factors ride at the two largest budgets."""
    ex = dict(use_kernel=use_kernel, fuse_level=fuse_level)
    cfg = index.config
    max_budget = cut * cfg.n_blocks          # selector top_k axis bound
    ladder = [b for b in (2, 4, 8, 16, 32, 64) if b <= max_budget]
    if not ladder:
        ladder = [max_budget]
    degree = min(index.graph_degree, 8)
    refine = [(0, 0)]
    if degree > 0:
        refine += [(degree, 1), (degree, 2)]
    grid: list[SearchParams] = []
    for budget in ladder:
        for deg, rounds in refine:
            grid.append(SearchParams(
                k=k, cut=cut, block_budget=budget, policy="budget",
                graph_degree=deg, refine_rounds=rounds, **ex))
    for budget in ladder[-2:]:
        for hf in (0.8, 0.9):
            grid.append(SearchParams(k=k, cut=cut, block_budget=budget,
                                     policy="adaptive", heap_factor=hf,
                                     probe_budget=min(8, budget), **ex))
        for tf in (0.6, 0.75):
            grid.append(SearchParams(k=k, cut=cut, block_budget=budget,
                                     policy="global_threshold",
                                     threshold_factor=tf, **ex))
    if index.sup_coords is not None:
        f = cfg.superblock_fanout
        for budget in ladder:
            for deg, rounds in refine:
                grid.append(SearchParams(
                    k=k, cut=cut, block_budget=budget, policy="budget",
                    superblock_fanout=f,
                    superblock_budget=max(2, budget // max(f // 2, 1)),
                    graph_degree=deg, refine_rounds=rounds, **ex))
    return grid


def measure_point(index: SeismicIndex, queries: PaddedSparse,
                  exact_ids, p: SearchParams, *,
                  timings: bool = False) -> MeasuredPoint:
    """Run one operating point over the whole held-out batch."""
    stage_s: dict[str, float] = {}
    if timings:
        def record(name, secs):
            stage_s[name] = stage_s.get(name, 0.0) + secs

        _, ids, ev = run_pipeline_staged(index, queries.coords,
                                         queries.vals, p, record=record)
    else:
        _, ids, ev = search_pipeline(index, queries, p)
    ev = host_array(ev).astype(np.int64)
    # sorted before the mean: bit-identical under sample permutation
    rec = np.sort(per_query_recall(ids, exact_ids))
    recall = float(rec.sum() / rec.size)
    docs = float(int(ev.sum()) / ev.size)
    return MeasuredPoint(
        params=p, recall=recall, docs_evaluated=docs,
        router_cost=router_work(index.config, p,
                                query_nnz=queries.coords.shape[1]),
        stage_seconds=tuple(sorted(stage_s.items())))


def sweep(index: SeismicIndex, queries: PaddedSparse, exact_ids, *,
          k: int = 10, cut: int = 8,
          grid: Sequence[SearchParams] | None = None,
          timings: bool = False) -> list[MeasuredPoint]:
    """Measure every grid point (default: :func:`default_grid`), in grid
    order, each distinct point once."""
    if grid is None:
        grid = default_grid(index, k=k, cut=cut)
    seen: set[SearchParams] = set()
    points = []
    for p in grid:
        if p in seen:
            continue
        seen.add(p)
        points.append(measure_point(index, queries, exact_ids, p,
                                    timings=timings))
    return points
