"""Stage 1 — prep: batch query densification + probed-coordinate cut."""
from __future__ import annotations

import torch

from repro_torch.sparse.ops import PaddedSparse, densify, top_k


def probed_width(cut: int, query_nnz: int) -> int:
    """Lists each query of a ``[Q, query_nnz]`` batch probes: ``cut``, or
    the batch's width where that is narrower (a query probes its own
    coordinates only)."""
    return min(cut, query_nnz)


def prep_queries(q_coords: torch.Tensor, q_vals: torch.Tensor, dim: int,
                 cut: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[Q, nnz] padded-sparse queries -> (q_dense [Q, d] f32,
    lists [Q, C] int32, list_vals [Q, C]), ``C = probed_width(cut, nnz)``.

    A batch narrower than the cut probes each query's ``nnz`` coordinates
    and answers as the same batch at ``cut = nnz``. Padded entries (val
    == 0) inside a batch map to coord 0 with val 0; probing coord 0
    repeatedly is harmless — its routed blocks dedupe downstream."""
    vals = q_vals.to(torch.float32)
    q_dense = densify(PaddedSparse(q_coords, vals, dim))
    cv, idx = top_k(vals, probed_width(cut, vals.shape[1]))  # [Q, C]
    cc = q_coords.gather(1, idx)
    cc = torch.where(cv > 0, cc, 0)
    cv = torch.where(cv > 0, cv, 0.0)
    return q_dense, cc.to(torch.int32), cv
