"""Plain PyTorch version of the scorer's candidates: the selected blocks'
doc ids gathered, masked, sorted, deduped and compacted, as the scorer's
torch operations do it at fuse level 1."""
from __future__ import annotations

import torch


def block_candidates_ref(blocks, lists, block_off, block_len, list_docs,
                         block_scores, tombstone, n_docs: int,
                         block_cap: int) -> torch.Tensor:
    """blocks [Q, B] (flat ids into the (cut, n_blocks) router scores) ->
    cand [Q, B * block_cap] int32: live ids ascending and unique, then
    ``n_docs``. A block whose score is not finite, a slot past its
    block's length and a tombstoned id are the sentinel ``n_docs``."""
    nb = block_off.shape[1]
    lam = list_docs.shape[1]
    coord = lists.long().gather(1, blocks // nb)          # [Q, B]
    bi = blocks % nb
    off = block_off[coord, bi]
    ln = block_len[coord, bi]
    ar = torch.arange(block_cap, device=blocks.device)
    pos = (off[..., None] + ar).clamp(0, lam - 1)
    docs = list_docs[coord[..., None], pos]
    docs = torch.where(ar < ln[..., None], docs, n_docs)
    if block_scores is not None:
        docs = torch.where(torch.isfinite(block_scores)[..., None], docs,
                           n_docs)
    cand = docs.reshape(blocks.shape[0], -1)
    if tombstone is not None:
        dead = tombstone[cand.long().clamp(0, tombstone.shape[0] - 1)]
        cand = torch.where(dead, n_docs, cand)
    s = torch.sort(cand, dim=-1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    return torch.sort(torch.where(dup, n_docs, s), dim=-1).values.to(
        torch.int32)
