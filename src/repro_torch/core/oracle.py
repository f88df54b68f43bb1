"""Exact brute-force retrieval and recall (port of ``repro.core.oracle``).

``exact_topk`` scores every document for a whole query batch on the
device, ``doc_chunk`` documents at a time, in float64 (the JAX oracle's
precision), keeping a running top-k. Ties keep the lower doc id, as the
JAX oracle's stable argsort does.
"""
from __future__ import annotations

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
