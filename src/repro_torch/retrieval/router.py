"""Stage 2 — router: quantized summary scoring (paper phase R).

The flat route scores EVERY summary of every probed list for the whole
query batch: the flattened (probed list, block) axis has length
``cut * n_blocks`` and the result is ``r [Q, cut * n_blocks]`` with dead
blocks at -inf. With ``use_kernel`` the dots run in the summary_dot CUDA
kernel (u8 dequant fused). Hierarchical routing is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch

from repro_torch.retrieval.params import SearchParams
from repro_torch.sparse.quant import dequantize_u8

if TYPE_CHECKING:
    from repro_torch.core.types import SeismicIndex

NEG = -torch.inf


@dataclasses.dataclass(frozen=True)
class RoutedBatch:
    """Everything the selector and scorer stages need, batched."""

    q_dense: torch.Tensor   # f32 [Q, d]
    lists: torch.Tensor     # i32 [Q, cut]     probed coordinate per slot
    r: torch.Tensor         # f32 [Q, cut*nb]  block summary scores (-inf dead)


def _summary_scores(q_dense, sc, sq, scale, zero, use_kernel: bool):
    """<q, dequant(summary)> over a flat [Q, L, S] summary axis."""
    if use_kernel:
        from repro_torch.kernels.summary_dot.ops import summary_dot_batch
        return summary_dot_batch(q_dense, sc, sq, scale, zero)
    qn = sc.shape[0]
    sv = dequantize_u8(sq, scale, zero)
    gathered = q_dense.gather(1, sc.reshape(qn, -1).long()).reshape(sc.shape)
    return (gathered * sv).sum(dim=-1)


def _route_flat(index: "SeismicIndex", q_dense: torch.Tensor,
                lists: torch.Tensor, p: SearchParams) -> RoutedBatch:
    """Summary inner products for all blocks of the probed lists."""
    qn, cut = lists.shape
    nb = index.config.n_blocks
    s = index.sum_coords.shape[-1]
    li = lists.long()
    sc = index.sum_coords[li].reshape(qn, cut * nb, s)       # [Q, L, S]
    sq = index.sum_q[li].reshape(qn, cut * nb, s)
    scale = index.sum_scale[li].reshape(qn, cut * nb)
    zero = index.sum_zero[li].reshape(qn, cut * nb)
    r = _summary_scores(q_dense, sc, sq, scale, zero, p.use_kernel)
    alive = (index.block_len[li] > 0).reshape(qn, cut * nb)
    r = torch.where(alive, r, NEG)
    return RoutedBatch(q_dense=q_dense, lists=lists, r=r)


def route_batch(index: "SeismicIndex", q_dense: torch.Tensor,
                lists: torch.Tensor, p: SearchParams) -> RoutedBatch:
    """Phase R for the whole batch (flat route)."""
    if p.superblock_fanout > 0:
        raise NotImplementedError(
            "hierarchical routing (superblock_fanout > 0) is not ported yet "
            "(ROADMAP Queue 1, hierarchical routing and the superblock "
            "build)")
    return _route_flat(index, q_dense, lists, p)


def router_work(cfg, p: SearchParams) -> int:
    """Summary inner products the router evaluates per query (flat:
    ``cut * n_blocks``)."""
    if p.superblock_fanout <= 0:
        return p.cut * cfg.n_blocks
    coarse = p.cut * cfg.n_superblocks
    return coarse + min(p.superblock_budget, coarse) * p.superblock_fanout
