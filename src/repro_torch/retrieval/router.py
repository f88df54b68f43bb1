"""Stage 2 — router: quantized summary scoring (paper phase R).

Two routes behind ``SearchParams.superblock_fanout``:

* **flat** (``superblock_fanout == 0``): scores EVERY summary of every
  probed list for the whole query batch; the flattened (probed list,
  block) axis has length ``cut * n_blocks`` and the result is
  ``r [Q, cut * n_blocks]`` with dead blocks at -inf.
* **hierarchical** (``superblock_fanout > 0``, on an index built with the
  same fanout): stage A scores the superblock tier (``cut *
  n_superblocks`` summaries, each upper-bounding its children); stage B
  keeps the top ``superblock_budget`` superblocks per query and scores
  only their children's block summaries, scattered back into the flat
  ``[Q, cut * n_blocks]`` layout with pruned blocks at -inf. The
  selectors consume either result unchanged.

Each route is written once, in ``kernels.router_fused.ref``, with the
summary dot as a parameter: with ``use_kernel`` the unfused tiers run the
summary_dot CUDA kernel, else its plain version. With ``fuse_level >= 2``
each route is one fused launch
(``kernels.router_fused``): the probed summary rows are read in-kernel
and never gathered into a ``[Q, L, S]`` copy; the hierarchical route
keeps only the output-sized scatter on the host. Every kernel scores a
summary row with the same row dot, so on the card fuse levels 0 and 2
give bitwise equal scores.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch

from repro_torch.retrieval.params import SearchParams
from repro_torch.retrieval.prep import probed_width

if TYPE_CHECKING:
    from repro_torch.core.types import SeismicIndex

NEG = -torch.inf


@dataclasses.dataclass(frozen=True)
class RoutedBatch:
    """Everything the selector and scorer stages need, batched."""

    q_dense: torch.Tensor   # f32 [Q, d]
    lists: torch.Tensor     # i32 [Q, cut]     probed coordinate per slot
    r: torch.Tensor         # f32 [Q, cut*nb]  block summary scores (-inf dead)


def _summary_dot(use_kernel: bool):
    """<q, dequant(summary)> over a flat [Q, L, S] summary axis: the
    summary_dot kernel, or its plain version."""
    if use_kernel:
        from repro_torch.kernels.summary_dot.ops import summary_dot_batch
        return summary_dot_batch
    from repro_torch.kernels.summary_dot.ref import summary_dot_batch_ref
    return summary_dot_batch_ref


def _route_flat(index: "SeismicIndex", q_dense: torch.Tensor,
                lists: torch.Tensor, p: SearchParams) -> RoutedBatch:
    """Summary inner products for all blocks of the probed lists."""
    from repro_torch.kernels.router_fused.ops import (router_flat_batch,
                                                      router_flat_ref)
    args = (lists, q_dense, index.sum_coords, index.sum_q, index.sum_scale,
            index.sum_zero, index.block_len)
    if p.fuse_level >= 2:
        r = router_flat_batch(*args)
    else:
        r = router_flat_ref(*args, dot=_summary_dot(p.use_kernel))
    return RoutedBatch(q_dense=q_dense, lists=lists, r=r)


def _scatter_children(rb: torch.Tensor, flat: torch.Tensor,
                      width: int) -> torch.Tensor:
    """Child scores into the flat [Q, width] layout, -inf elsewhere. An
    amax, so clamped out-of-range children (``-inf``) that share a
    position with the real last block never overwrite it, whatever the
    order of the writes."""
    r = torch.full((rb.shape[0], width), NEG, dtype=rb.dtype,
                   device=rb.device)
    return r.scatter_reduce_(1, flat.long(), rb, "amax")


def _route_hierarchical(index: "SeismicIndex", q_dense: torch.Tensor,
                        lists: torch.Tensor, p: SearchParams) -> RoutedBatch:
    """Superblock tier -> survivors -> child block summaries.

    A block is pruned only when its superblock's score (>= the block's
    own summary score) misses the per-query top ``superblock_budget``."""
    from repro_torch.kernels.router_fused.ops import (router_hier_batch,
                                                      router_hier_ref)
    cut = lists.shape[1]
    cfg = index.config
    nb, f, ns = cfg.n_blocks, cfg.superblock_fanout, cfg.n_superblocks
    m = min(p.superblock_budget, cut * ns)
    args = (lists, q_dense, index.sup_coords, index.sup_q, index.sup_scale,
            index.sup_zero, index.sum_coords, index.sum_q, index.sum_scale,
            index.sum_zero, index.block_len)
    if p.fuse_level >= 2:
        rb, flat = router_hier_batch(*args, m=m, fanout=f)
    else:
        rb, flat = router_hier_ref(*args, m=m, fanout=f,
                                   dot=_summary_dot(p.use_kernel))
    return RoutedBatch(q_dense=q_dense, lists=lists,
                       r=_scatter_children(rb, flat, cut * nb))


def check_route(index: "SeismicIndex", p: SearchParams) -> None:
    """Raise ``ValueError`` when ``p`` asks for a route the index cannot
    serve (hierarchical routing without a matching superblock tier)."""
    if p.superblock_fanout <= 0:
        return
    if index.sup_coords is None:
        raise ValueError(
            "hierarchical routing requested (superblock_fanout="
            f"{p.superblock_fanout}) but the index has no superblock "
            "tier; build with SeismicConfig(superblock_fanout > 0)")
    if index.config.superblock_fanout != p.superblock_fanout:
        raise ValueError(
            f"superblock_fanout mismatch: SearchParams has "
            f"{p.superblock_fanout}, index was built with "
            f"{index.config.superblock_fanout}")


def route_batch(index: "SeismicIndex", q_dense: torch.Tensor,
                lists: torch.Tensor, p: SearchParams) -> RoutedBatch:
    """Phase R for the whole batch; flat or hierarchical per
    ``p.superblock_fanout`` (0 = flat)."""
    if p.superblock_fanout <= 0:
        return _route_flat(index, q_dense, lists, p)
    check_route(index, p)
    return _route_hierarchical(index, q_dense, lists, p)


def router_work(cfg, p: SearchParams, query_nnz: int | None = None) -> int:
    """Summary inner products the router evaluates per query, over the
    C lists a query probes (``p.cut``, or ``prep.probed_width`` of a
    batch ``query_nnz`` wide; None: at least ``p.cut`` wide) (flat:
    ``C * n_blocks``; hierarchical: ``C * n_superblocks +
    superblock_budget * fanout``)."""
    cut = p.cut if query_nnz is None else probed_width(p.cut, query_nnz)
    if p.superblock_fanout <= 0:
        return cut * cfg.n_blocks
    coarse = cut * cfg.n_superblocks
    return coarse + min(p.superblock_budget, coarse) * p.superblock_fanout
