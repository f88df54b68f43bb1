"""Plain PyTorch version of the fused refine round: expand, sort-dedupe,
seen-mask, sort-compact and rescore, as the unfused round does them."""
from __future__ import annotations

import torch

from repro_torch.kernels.gather_dot.ref import gather_dot_cand_ref


def refine_round_ref(ids, scored, q_dense, knn_ids, fwd_coords, fwd_vals,
                     fwd_scale, fwd_zero, n_docs: int, degree: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """ids [Q, k] (-1 padding) x scored [Q, W] -> (cand [Q, k*degree]
    int32, live ids as a sorted prefix; scores [Q, k*degree], -inf at
    the sentinel ``n_docs``)."""
    qn, k = ids.shape
    safe = ids.long().clamp(0, knn_ids.shape[0] - 1)
    nbrs = knn_ids[safe][..., :degree]                      # [Q, k, deg]
    nbrs = torch.where(ids[..., None] >= 0, nbrs, n_docs)
    s = torch.sort(nbrs.reshape(qn, k * degree).to(torch.int32),
                   dim=-1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    cand = torch.where(dup, n_docs, s)
    seen = (cand[:, :, None] == scored[:, None, :]).any(-1)
    cand = torch.sort(torch.where(seen, n_docs, cand), dim=-1).values
    return cand, gather_dot_cand_ref(q_dense, cand, fwd_coords, fwd_vals,
                                     fwd_scale, fwd_zero, n_docs)
