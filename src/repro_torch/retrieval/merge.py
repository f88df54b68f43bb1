"""Stage 5 — merge: final batched top-k over exact candidate scores."""
from __future__ import annotations

import torch

from repro_torch.sparse.ops import top_k


def merge_topk(cand: torch.Tensor, scores: torch.Tensor, k: int, n_docs: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cand [Q, C], scores [Q, C]) -> (top_s [Q, k], ids int32 [Q, k] with
    -1 padding, docs_evaluated int32 [Q]). Equal scores keep the earlier
    candidate. ``k`` may exceed C: the tail pads with -1 / -inf."""
    kk = min(k, scores.shape[-1])
    top_s, pos = top_k(scores, kk)
    top_ids = cand.gather(1, pos)
    top_ids = torch.where(torch.isfinite(top_s), top_ids, -1)
    if kk < k:
        qn = scores.shape[0]
        top_s = torch.cat([top_s, top_s.new_full((qn, k - kk), -torch.inf)],
                          dim=1)
        top_ids = torch.cat([top_ids, top_ids.new_full((qn, k - kk), -1)],
                            dim=1)
    docs_evaluated = (cand < n_docs).sum(dim=-1).to(torch.int32)
    return top_s, top_ids.to(torch.int32), docs_evaluated
