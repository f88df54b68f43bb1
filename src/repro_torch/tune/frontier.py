"""Recall/cost Pareto frontier and recall-target operating-point
selection (port of ``repro.tune.frontier``).

All ordering is by ``MeasuredPoint.cost_key`` (the deterministic
(docs_evaluated, router_cost, knob tuple) triple), never by wall time or
sweep order, so the selected point is bit-reproducible and invariant to a
permutation of the held-out query sample.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Sequence

from repro_torch.device import host_array
from repro_torch.tune.policy import (RECALL_EPS, TunedPolicy, attach_tuned,
                                     knobs_from_params, sample_fingerprint)
from repro_torch.tune.sweep import MeasuredPoint, sweep

if TYPE_CHECKING:
    from repro_torch.core.types import SeismicIndex
    from repro_torch.sparse.ops import PaddedSparse


def pareto_frontier(points: Sequence[MeasuredPoint]
                    ) -> list[MeasuredPoint]:
    """The non-dominated subset, cost-ascending and recall-ascending.

    A point is kept iff no other point reaches at least its recall at a
    lower (docs_evaluated, router_cost) pair, nor the same pair at higher
    recall: equal-cost points are scanned recall-descending (the knob
    tuple breaks only exact (cost, recall) ties). The result is strictly
    monotone: higher recall costs more."""
    frontier: list[MeasuredPoint] = []
    best = float("-inf")
    for pt in sorted(points,
                     key=lambda t: (t.docs_evaluated, t.router_cost,
                                    -t.recall,
                                    dataclasses.astuple(t.params))):
        if pt.recall > best + RECALL_EPS:
            frontier.append(pt)
            best = pt.recall
    return frontier


def select_operating_point(points: Sequence[MeasuredPoint],
                           target: float) -> MeasuredPoint:
    """The cheapest measured point whose recall meets ``target``; raises
    ``ValueError`` naming the best achievable recall when none does."""
    feasible = [pt for pt in points if pt.recall >= target - RECALL_EPS]
    if not feasible:
        best = max((pt.recall for pt in points), default=0.0)
        raise ValueError(
            f"recall target {target:.4f} is infeasible on this sweep "
            f"(best achievable {best:.4f} over {len(points)} points); "
            "widen the grid (larger block_budget / refine_rounds) or "
            "lower the target")
    return min(feasible, key=lambda pt: pt.cost_key)


def policy_from_point(point: MeasuredPoint, target: float,
                      fingerprint: str = "", *,
                      modeled: bool = False) -> TunedPolicy:
    """Freeze a selected point into the persistable artifact."""
    return TunedPolicy(target=target,
                       measured_recall=point.recall,
                       measured_cost=point.docs_evaluated,
                       router_cost=point.router_cost,
                       sample_fingerprint=fingerprint, modeled=modeled,
                       **knobs_from_params(point.params))


def tune(index: SeismicIndex, queries: PaddedSparse, exact_ids,
         target: float, *, k: int = 10, cut: int = 8, grid=None,
         timings: bool = False,
         points: Sequence[MeasuredPoint] | None = None) -> TunedPolicy:
    """Sweep (unless ``points`` is a measured sweep), select the cheapest
    point meeting ``target`` and freeze it. The same index, sample (in any
    order) and grid give the identical ``TunedPolicy``, bit for bit."""
    if points is None:
        points = sweep(index, queries, exact_ids, k=k, cut=cut,
                       grid=grid, timings=timings)
    chosen = select_operating_point(points, target)
    return policy_from_point(chosen, target, sample_fingerprint(
        host_array(queries.coords), host_array(queries.vals)))


def tune_and_attach(index: SeismicIndex, queries: PaddedSparse, exact_ids,
                    targets: Sequence[float], *, k: int = 10, cut: int = 8,
                    grid=None, timings: bool = False) -> SeismicIndex:
    """Tune one policy per target over a single shared sweep and attach
    them to the index (``ckpt.save_index`` then persists them)."""
    points = sweep(index, queries, exact_ids, k=k, cut=cut, grid=grid,
                   timings=timings)
    pols = [tune(index, queries, exact_ids, t, points=points)
            for t in targets]
    return attach_tuned(index, pols)
