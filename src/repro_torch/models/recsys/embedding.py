"""Embedding tables and EmbeddingBag (port of
``repro/models/recsys/embedding.py``, off a mesh).

Layout: all categorical fields live in ONE fused table [R_total, D] with
per-field row offsets (the production packing). A lookup is
``F.embedding``: a gather forward, and a backward that sorts the ids and
sums each row's gradients in order, with no atomic add, so a training
step repeats bitwise on the card. The JAX package's model-sharded lookup
(a ``shard_map`` over the table's rows with a psum) runs only under a
mesh, which waits for the port of ``distributed/`` (ROADMAP Queue 1,
item 5).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import draw


def field_offsets(table_rows: tuple[int, ...]) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(table_rows)[:-1]]).astype(np.int64)


def padded_rows(n: int, mult: int = 512) -> int:
    """Round table rows up so row-sharding divides any mesh axis."""
    return -(-n // mult) * mult


def init_table(n_rows: int, dim: int, dtype: torch.dtype,
               device: torch.device, generator: torch.Generator | None,
               ) -> nn.Parameter:
    """[n_rows, dim], standard normal times 0.01."""
    return draw((n_rows, dim), 0.01, dtype, device, generator)


def lookup(table: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """Row lookup [...] -> [..., D]."""
    return F.embedding(gids.long(), table)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag: ids [B, L] with validity mask [B, L] -> [B, D], a
    lookup and a masked sum (or mean over the valid ids)."""
    emb = lookup(table, ids)                       # [B, L, D]
    emb = emb * mask[..., None].to(emb.dtype)
    out = emb.sum(dim=1)
    if mode == "mean":
        out = out / mask.sum(dim=1, keepdim=True).to(out.dtype).clamp_min(1.0)
    return out


def fielded_lookup(table: torch.Tensor, ids: torch.Tensor,
                   offsets) -> torch.Tensor:
    """ids [B, F] per-field local ids -> [B, F, D] via the fused table;
    ``offsets`` [F] (numpy or a tensor) are the fields' first rows."""
    offs = torch.as_tensor(offsets, dtype=torch.int64, device=ids.device)
    return lookup(table, ids.long() + offs[None, :])
