"""Exact brute-force retrieval, recall, and the paper's Algorithm 2 as a
host oracle (port of ``repro.core.oracle``).

``exact_topk`` scores every document for a whole query batch on the
device, ``doc_chunk`` documents at a time, in float64 (the JAX oracle's
precision), keeping a running top-k. Ties keep the lower doc id, as the
JAX oracle's stable argsort does.

``algorithm2`` is a line-by-line numpy/heapq implementation of the
paper's Algorithm 2 (coordinate at a time, a min-heap, heap_factor block
skipping) over a :class:`NumpyIndexView` of a port index: a host oracle
that cross-checks the batched query path and never runs on the card.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.sparse.ops import PaddedSparse, densify, widen_coords


def exact_topk(doc_coords: torch.Tensor, doc_vals: torch.Tensor, dim: int,
               q_coords: torch.Tensor, q_vals: torch.Tensor, k: int, *,
               doc_chunk: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Brute force over the padded-sparse collection [N, nnz] for queries
    [Q, nnz] -> (scores f64 [Q, k], ids int64 [Q, k]), on the
    collection's device."""
    q = densify(PaddedSparse(q_coords, q_vals, dim), dtype=torch.float64)
    qn, n, nnz = q.shape[0], doc_coords.shape[0], doc_coords.shape[1]
    if doc_chunk is None:   # keep the [Q, chunk, nnz] gather near 1 GiB
        doc_chunk = max(1, (1 << 30) // max(qn * nnz * 8, 1))
    best_s = q.new_empty((qn, 0))
    best_i = torch.empty((qn, 0), dtype=torch.int64, device=q.device)
    for s in range(0, n, doc_chunk):
        c = widen_coords(doc_coords[s:s + doc_chunk])
        v = doc_vals[s:s + doc_chunk].to(torch.float64)
        scores = (q[:, c] * v).sum(dim=-1)                  # [Q, chunk]
        ids = torch.arange(s, s + c.shape[0], device=q.device)
        cat_s = torch.cat([best_s, scores], dim=1)
        cat_i = torch.cat([best_i, ids.expand(qn, -1)], dim=1)
        top_s, pos = torch.sort(cat_s, dim=1, descending=True, stable=True)
        best_s, best_i = top_s[:, :k], cat_i.gather(1, pos[:, :k])
    return best_s, best_i


def _host64(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float64).cpu().numpy()


class NumpyIndexView:
    """Host numpy view of a port ``SeismicIndex``: the forward values (a
    bf16 or u8 plane included, dequantized with its per-doc scale and
    zero) as float64, u16 coordinates widened to int64."""

    def __init__(self, index):
        self.fwd_coords = widen_coords(index.fwd.coords).cpu().numpy()
        vals = index.fwd.vals
        if index.fwd_scale is not None:
            from repro_torch.sparse.quant import dequantize_u8
            vals = dequantize_u8(vals, index.fwd_scale, index.fwd_zero)
        self.fwd_vals = _host64(vals)
        self.list_docs = index.list_docs.cpu().numpy()
        self.list_len = index.list_len.cpu().numpy()
        self.block_off = index.block_off.cpu().numpy()
        self.block_len = index.block_len.cpu().numpy()
        self.sum_coords = index.sum_coords.cpu().numpy()
        self.sum_q = index.sum_q.cpu().numpy()
        self.sum_scale = index.sum_scale.cpu().numpy()
        self.sum_zero = index.sum_zero.cpu().numpy()
        self.dim = index.dim
        self.n_docs = index.n_docs

    def summary(self, i: int, j: int) -> tuple[np.ndarray, np.ndarray]:
        q = self.sum_q[i, j].astype(np.float64)
        v = np.where(q > 0,
                     (q - 1.0) * self.sum_scale[i, j] + self.sum_zero[i, j],
                     0.0)
        return self.sum_coords[i, j], v


def algorithm2(view: NumpyIndexView, q_coords: np.ndarray,
               q_vals: np.ndarray, k: int, cut: int, heap_factor: float):
    """Paper Algorithm 2, verbatim control flow, on the host.

    Returns (scores desc [k], ids [k], stats dict). A document met again
    in another list is skipped on heap insert (set membership): its score
    is the same each time it is evaluated."""
    q_coords = np.asarray(q_coords)
    q_vals = np.asarray(q_vals)
    q_dense = np.zeros(view.dim, np.float64)
    np.add.at(q_dense, q_coords, q_vals.astype(np.float64))
    order = np.argsort(-q_vals, kind="stable")[:cut]
    probe = [int(q_coords[o]) for o in order if q_vals[o] > 0]

    heap: list[tuple[float, int]] = []   # min-heap of (score, doc)
    in_heap: set[int] = set()
    docs_evaluated = 0
    blocks_scored = 0
    blocks_skipped = 0

    for i in probe:                                   # line 3
        nb = view.block_off.shape[1]
        for j in range(nb):                           # line 4
            ln = int(view.block_len[i, j])
            if ln == 0:
                continue
            sc, sv = view.summary(i, j)
            r = float((q_dense[sc] * sv).sum())       # line 5
            blocks_scored += 1
            if len(heap) == k and r < heap[0][0] / heap_factor:   # line 6
                blocks_skipped += 1
                continue                              # line 7
            off = int(view.block_off[i, j])
            for d in view.list_docs[i, off:off + ln]:  # line 8
                d = int(d)
                if d >= view.n_docs:
                    continue
                docs_evaluated += 1
                p = float((q_dense[view.fwd_coords[d]]
                           * view.fwd_vals[d]).sum())  # line 9
                if d in in_heap:
                    continue
                if len(heap) < k or p > heap[0][0]:    # line 10
                    heapq.heappush(heap, (p, d))       # line 11
                    in_heap.add(d)
                    if len(heap) == k + 1:             # line 12
                        _, popped = heapq.heappop(heap)  # line 13
                        in_heap.discard(popped)

    out = sorted(heap, reverse=True)
    scores = np.array([s for s, _ in out], np.float64)
    ids = np.array([d for _, d in out], np.int64)
    stats = dict(docs_evaluated=docs_evaluated, blocks_scored=blocks_scored,
                 blocks_skipped=blocks_skipped)
    return scores, ids, stats


def recall_at_k(approx_ids, exact_ids) -> float:
    """|approx ∩ exact| / |exact| — the paper's "accuracy", over the
    flattened id sets; ids < 0 (the pipeline's -1 padding) are dropped
    from both sides, ties are not forgiven."""
    def ids(x):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return {int(i) for i in x.reshape(-1) if i >= 0}
    a, e = ids(approx_ids), ids(exact_ids)
    return len(a & e) / max(len(e), 1)


def mean_recall_at_k(approx_ids: torch.Tensor,
                     exact_ids: torch.Tensor) -> float:
    """Mean over rows of :func:`recall_at_k` for [Q, k] batches of
    distinct ids per row (as the pipeline returns)."""
    hit = (approx_ids[:, :, None].long() == exact_ids[:, None, :].long())
    hit &= (approx_ids >= 0)[:, :, None] & (exact_ids >= 0)[:, None, :]
    denom = (exact_ids >= 0).sum(dim=1).clamp(min=1)
    return float((hit.any(dim=2).sum(dim=1) / denom).mean())
