"""Stage 3 — selector: pluggable block-selection policies.

A selector maps the routed batch to a fixed-shape block selection:

    fn(index, batch: RoutedBatch, p: SearchParams) -> Selection

Blocks it wants ignored keep a -inf score; the scorer masks their docs
to the sentinel. ``SearchParams.policy`` picks the registry entry. Every
top-k here uses :func:`repro_torch.sparse.ops.top_k` (lowest index first
on ties, as ``jax.lax.top_k``).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable

import torch

from repro_torch.retrieval.params import SearchParams
from repro_torch.retrieval.router import NEG, RoutedBatch
from repro_torch.sparse.ops import top_k

if TYPE_CHECKING:
    from repro_torch.core.types import SeismicIndex


@dataclasses.dataclass(frozen=True)
class Selection:
    """Fixed-shape batched block selection."""

    blocks: torch.Tensor        # i64 [Q, B] flat ids into RoutedBatch.r
    block_scores: torch.Tensor  # f32 [Q, B] summary scores (-inf = masked)


SelectorFn = Callable[["SeismicIndex", RoutedBatch, SearchParams], Selection]

_SELECTORS: dict[str, SelectorFn] = {}


def register_selector(name: str, fn: SelectorFn | None = None):
    """Register a block-selection policy (usable as a decorator)."""
    def wrap(f: SelectorFn) -> SelectorFn:
        _SELECTORS[name] = f
        return f
    return wrap if fn is None else wrap(fn)


def get_selector(name: str) -> SelectorFn:
    try:
        return _SELECTORS[name]
    except KeyError:
        raise KeyError(f"unknown selector policy {name!r}; "
                       f"registered: {sorted(_SELECTORS)}") from None


def selector_names() -> tuple[str, ...]:
    return tuple(sorted(_SELECTORS))


@register_selector("budget")
def select_budget(index: "SeismicIndex", batch: RoutedBatch,
                  p: SearchParams) -> Selection:
    """Top ``block_budget`` blocks by summary score."""
    scores, blocks = top_k(batch.r, p.block_budget)
    return Selection(blocks=blocks, block_scores=scores)


@register_selector("global_threshold")
def select_global_threshold(index: "SeismicIndex", batch: RoutedBatch,
                            p: SearchParams) -> Selection:
    """Keep blocks whose summary score clears ``threshold_factor`` of the
    per-query best block, capped at ``block_budget``."""
    rmax = batch.r.amax(dim=-1, keepdim=True)               # [Q, 1]
    passing = batch.r >= rmax * p.threshold_factor
    kept = torch.where(passing, batch.r, NEG)
    scores, blocks = top_k(kept, p.block_budget)
    return Selection(blocks=blocks, block_scores=scores)


@register_selector("adaptive")
def select_adaptive(index: "SeismicIndex", batch: RoutedBatch,
                    p: SearchParams) -> Selection:
    """Two-stage emulation of Alg. 2's heap_factor pruning: stage 1 fully
    scores the top ``probe_budget`` blocks to bootstrap a k-th-best
    estimate theta; stage 2 keeps only blocks with
    summary >= theta / heap_factor (capped at block_budget)."""
    from repro_torch.retrieval.scorer import (score_candidates,
                                              selected_candidates)
    probe = min(p.probe_budget, p.block_budget)
    r1, b1 = top_k(batch.r, probe)
    # the probe's blocks are scored whatever their summary score
    cand1 = selected_candidates(index, batch.lists, b1,
                                fuse_level=p.fuse_level)
    s1 = score_candidates(index, batch.q_dense, cand1, p.use_kernel,
                          fuse_level=p.fuse_level)
    theta = top_k(s1, p.k)[0][:, p.k - 1]                   # [Q]
    theta = torch.where(torch.isfinite(theta), theta, NEG)
    r2 = batch.r.scatter(1, b1, NEG)                        # already done
    # true division (a scalar divisor would become a reciprocal multiply)
    bound = theta / torch.full_like(theta, p.heap_factor)
    passing = r2 >= bound[:, None]
    r2 = torch.where(passing, r2, NEG)
    v2, b2 = top_k(r2, p.block_budget - probe)
    return Selection(blocks=torch.cat([b1, b2], dim=1),
                     block_scores=torch.cat([r1, v2], dim=1))
