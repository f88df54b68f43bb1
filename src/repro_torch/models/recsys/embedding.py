"""Embedding tables and EmbeddingBag (port of
``repro/models/recsys/embedding.py``).

Layout: all categorical fields live in ONE fused table [R_total, D] with
per-field row offsets (the production packing). A lookup is
``F.embedding``: a gather forward, and a backward that sorts the ids and
sums each row's gradients in order, with no atomic add, so a training
step repeats bitwise on the card.

Under a mesh the table rows are sharded over the model axis
(``recsys_param_specs``: the rank holds its block of rows) and the
lookup is the classic model-parallel embedding: each rank resolves the
ids that fall in its row range, zeros elsewhere, and an all-reduce over
"model" completes the gather (O(B * F * D) on the wire). The ids are
the global batch. When its rows divide over the data axes
(``row_axes``) each rank looks up its block of them and the lookup
returns that block, as the JAX package's ``shard_map`` returns its
``out_specs`` block: everything after the lookup runs on the rank's
rows, as GSPMD runs it there. The models cut their other row inputs the
same way (``place_rows``), and a serving step gathers its scores at the
end (``gather_rows``). A batch that does not divide stays replicated.
The table's gradient is then the rank's part, summed over the data
ranks once by the train step (``optimizer.reduce_grads``), as every
other gradient is.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (axes_size, axis_index,
                                              dp_axes, entry_axes,
                                              mesh_axis_size, spec_of,
                                              tp_axis)
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


def row_axes(n: int) -> tuple[str, ...]:
    """The data axes a batch of ``n`` rows splits over on the ambient
    mesh: all of ``dp_axes()`` when ``n`` divides over them, else none
    (small request batches stay replicated), the JAX package's
    condition. Off a mesh, none."""
    axes = dp_axes()
    return axes if n % axes_size(axes) == 0 else ()


def place_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of ``t``, whose first dim is the global batch:
    its block over ``row_axes``, as ``lookup`` returns its rows."""
    return C.block(t, 0, row_axes(t.shape[0]))


def gather_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """A step's rows (``place_rows`` of a global batch of ``n``) back to
    all ``n`` on every rank: an all-gather over ``row_axes(n)``."""
    return C.all_gather(t, 0, row_axes(n))


def _row_sharded(table: torch.Tensor) -> bool:
    spec = spec_of(table)
    return spec is not None and len(spec) > 0 \
        and "model" in entry_axes(spec[0])


def lookup(table: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """Row lookup [...] -> [..., D] of this rank's rows of ``gids`` (the
    global ids: ``place_rows`` of them); model-sharded under a mesh.

    ``table`` is the whole table, or this rank's block of rows when it is
    row-sharded over "model" (its spec says so). The sharded branch is
    taken under the JAX package's condition: a model axis whose size
    divides the table's (global) rows. A whole table taken there is cut
    to the rank's block first, as the JAX ``shard_map``'s ``in_specs``
    cut it."""
    ids = place_rows(gids).long()
    tp = tp_axis()
    model = mesh_axis_size("model")
    sharded = tp is not None and _row_sharded(table)
    rows = table.shape[0] * (model if sharded else 1)
    if tp is None or rows % model != 0:
        return F.embedding(ids, table)
    if not sharded:
        table = C.scatter_to(table, 0, "model")
    per = table.shape[0]
    local = ids - axis_index("model") * per
    in_range = (local >= 0) & (local < per)
    got = F.embedding(local.clamp(0, per - 1), table)
    got = got * in_range[..., None].to(got.dtype)
    return C.reduce_from(got, "model")


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag: ids [B, L] with validity mask [B, L] -> [B, D] (this
    rank's rows, as ``lookup``), a lookup and a masked sum (or mean over
    the valid ids)."""
    emb = lookup(table, ids)                       # [B, L, D]
    mask = place_rows(mask)
    emb = emb * mask[..., None].to(emb.dtype)
    out = emb.sum(dim=1)
    if mode == "mean":
        out = out / mask.sum(dim=1, keepdim=True).to(out.dtype).clamp_min(1.0)
    return out


def fielded_lookup(table: torch.Tensor, ids: torch.Tensor,
                   offsets) -> torch.Tensor:
    """ids [B, F] per-field local ids -> [B, F, D] (this rank's rows, as
    ``lookup``) via the fused table; ``offsets`` [F] (numpy or a tensor)
    are the fields' first rows."""
    offs = torch.as_tensor(offsets, dtype=torch.int64, device=ids.device)
    return lookup(table, ids.long() + offs[None, :])
