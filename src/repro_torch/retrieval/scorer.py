"""Stage 4 — scorer: forward-index exact scoring (paper phase S).

Gathers the member docs of every selected block for the whole batch,
dedupes candidates per query (sort + neighbor mask), and computes exact
inner products against the forward index. With ``use_kernel`` the
gather_dot CUDA kernel scores the gathered ``[Q, C, nnz]`` rows; with
``fuse_level >= 1`` candidates are compacted (live ids to a sorted
prefix) and the candidate-driven kernel gathers forward rows itself and
skips all-sentinel tiles. At ``fuse_level >= 1`` one block_cand launch
makes the compacted candidates (up to its cap of 32,768 ids a query on
the card). Ids and ``docs_evaluated`` are equal at every level; the two
scoring kernels share one row dot, so scores are too.

Gathers clamp ids into range before indexing (the JAX ``mode="clip"``
would otherwise be an out-of-range index here) and mask afterwards.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.retrieval.router import NEG, RoutedBatch
from repro_torch.retrieval.selector import Selection
from repro_torch.sparse.ops import take_rows, widen_coords
from repro_torch.sparse.quant import dequantize_u8

if TYPE_CHECKING:
    from repro_torch.core.types import SeismicIndex


def gather_block_docs(index: "SeismicIndex", lists: torch.Tensor,
                      blocks: torch.Tensor) -> torch.Tensor:
    """Member doc ids of selected flat blocks -> [Q, B, block_cap];
    out-of-length slots pad with the sentinel ``n_docs``. Indexes
    ``list_docs[coord, pos]`` directly (never a ``[Q, B, lam]`` copy)."""
    cfg = index.config
    nb = cfg.n_blocks
    li = blocks // nb                               # [Q, B] probed-slot id
    bi = blocks % nb
    coord = lists.long().gather(1, li)              # [Q, B] coordinate
    off = index.block_off[coord, bi]
    ln = index.block_len[coord, bi]
    ar = torch.arange(cfg.block_cap, device=blocks.device)
    pos = (off[..., None] + ar).clamp(0, cfg.lam - 1)
    docs = index.list_docs[coord[..., None], pos]
    return torch.where(ar < ln[..., None], docs, index.n_docs)


def mask_tombstoned(index: "SeismicIndex", cand: torch.Tensor) -> torch.Tensor:
    """Deleted candidates -> sentinel (identity without tombstones)."""
    if index.tombstone is None:
        return cand
    dead = index.tombstone[cand.long().clamp(0, index.tombstone.shape[0] - 1)]
    return torch.where(dead, index.n_docs, cand)


def score_tail(index: "SeismicIndex", q_dense: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact scores for the unblocked tail segment -> ([Q, T], [Q, T]).
    Zero-score tail docs are masked back to the sentinel, as a fresh
    build would never have surfaced them as candidates."""
    tail = mask_tombstoned(index, index.tail_ids)
    cand = tail[None, :].expand(q_dense.shape[0], tail.shape[0])
    scores = score_candidates(index, q_dense, cand, use_kernel=False)
    live = (cand < index.n_docs) & (scores > 0)
    return torch.where(live, cand, index.n_docs), \
        torch.where(live, scores, NEG)


def dedupe_batch(cand: torch.Tensor, n_docs: int) -> torch.Tensor:
    """Sort each query's candidate ids and mask duplicates to the
    sentinel. [Q, C] -> [Q, C]."""
    s = torch.sort(cand, dim=-1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    return torch.where(dup, n_docs, s)


def compact_candidates(cand: torch.Tensor) -> torch.Tensor:
    """Pack live candidate ids into a sorted prefix, sentinels into the
    tail, preserving the live ids' ascending order. [Q, C] -> [Q, C]."""
    return torch.sort(cand, dim=-1).values


def score_candidates(index: "SeismicIndex", q_dense: torch.Tensor,
                     cand: torch.Tensor, use_kernel: bool, *,
                     fuse_level: int = 0) -> torch.Tensor:
    """Exact <q, doc> for candidate ids [Q, C] (sentinel -> -inf). A
    compact (fwd_quant) index dequantizes per doc inside the dot."""
    fwd = index.fwd
    if fuse_level >= 1:
        from repro_torch.kernels.gather_dot.ops import gather_dot_cand_batch
        return gather_dot_cand_batch(
            q_dense, cand.to(torch.int32), fwd.coords, fwd.vals,
            index.fwd_scale, index.fwd_zero, n_docs=index.n_docs)
    idx = cand.long().clamp(0, index.n_docs - 1)
    c = take_rows(fwd.coords, idx)                   # [Q, C, nnz]
    v = fwd.vals[idx]
    quant = index.fwd_scale is not None
    scale = zero = None
    if quant:
        scale, zero = index.fwd_scale[idx], index.fwd_zero[idx]
    if use_kernel:
        from repro_torch.kernels.gather_dot.ops import gather_dot_batch
        scores = gather_dot_batch(q_dense, c, v, scale, zero)
    else:
        v = dequantize_u8(v, scale, zero) if quant else v.to(torch.float32)
        qn = cand.shape[0]
        gathered = q_dense.gather(1, widen_coords(c).reshape(qn, -1))
        scores = (gathered.reshape(c.shape) * v).sum(dim=-1)
    return torch.where(cand < index.n_docs, scores, NEG)


def selected_candidates(index: "SeismicIndex", lists: torch.Tensor,
                        blocks: torch.Tensor,
                        block_scores: torch.Tensor | None = None, *,
                        fuse_level: int = 0) -> torch.Tensor:
    """Selected blocks [Q, B] -> deduped candidate ids [Q, B*cap]; with
    ``block_scores`` a block whose score is not finite gives only
    sentinels, and a mutable index masks its tombstoned ids. At
    ``fuse_level >= 1`` the live ids are a sorted prefix, made by one
    block_cand launch (its plain version on the CPU)."""
    if fuse_level >= 1:
        from repro_torch.kernels.block_cand import ops as block_cand
        return block_cand.block_candidates(
            blocks, lists, index.block_off, index.block_len,
            index.list_docs, block_scores, index.tombstone,
            n_docs=index.n_docs, block_cap=index.config.block_cap)
    docs = gather_block_docs(index, lists, blocks)
    if block_scores is not None:
        docs = torch.where(torch.isfinite(block_scores)[..., None], docs,
                           index.n_docs)
    return dedupe_batch(mask_tombstoned(index, docs.reshape(
        blocks.shape[0], -1)), index.n_docs)


def score_selection(index: "SeismicIndex", batch: RoutedBatch,
                    sel: Selection, use_kernel: bool, *,
                    fuse_level: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Selected blocks -> (cand [Q, B*cap], exact scores [Q, B*cap]).
    Blocks with a -inf selection score contribute only sentinels. A
    mutable index adds tombstone masking before dedupe and its exactly
    scored tail after the blocked candidates."""
    cand = selected_candidates(index, batch.lists, sel.blocks,
                               sel.block_scores, fuse_level=fuse_level)
    scores = score_candidates(index, batch.q_dense, cand, use_kernel,
                              fuse_level=fuse_level)
    if index.tail_ids is not None:
        tail_cand, tail_scores = score_tail(index, batch.q_dense)
        cand = torch.cat([cand, tail_cand.to(cand.dtype)], dim=1)
        scores = torch.cat([scores, tail_scores], dim=1)
    return cand, scores
