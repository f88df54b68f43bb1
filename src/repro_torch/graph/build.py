"""Offline kNN-graph construction over a built index (port of
``repro.graph.build``).

The graph comes from the port's own batched ``search_pipeline`` run over
the corpus: every document's forward row becomes a query, the pipeline's
merged top-(degree+1) answers it, and the document's own id is dropped
from its row. At the pipeline's defaults (``use_kernel=True``,
``fuse_level=1``) the summary_dot and gather_dot_cand kernels do the
work on the card.

``compact_forward=True`` first swaps the forward plane for u8 values with
per-doc affine constants and u16 coordinates (``dim < 65536``), so the
scorer and the refine rescore share one compact plane.

Neighbours are stored score-descending with the sentinel ``n_docs`` for
missing edges, so any prefix of a higher-degree graph is a valid
lower-degree one.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch

from repro_torch.retrieval.params import SearchParams
from repro_torch.sparse.ops import PaddedSparse, widen_coords
from repro_torch.sparse.quant import dequantize_u8, quantize_u8

if TYPE_CHECKING:
    from repro_torch.core.types import SeismicIndex


def doc_queries(index: "SeismicIndex") -> PaddedSparse:
    """The corpus as a query batch: int32 coords, dequantized f32 rows."""
    fwd = index.fwd
    if index.fwd_scale is not None:
        vals = dequantize_u8(fwd.vals, index.fwd_scale, index.fwd_zero)
    else:
        vals = fwd.vals.to(torch.float32)
    return PaddedSparse(widen_coords(fwd.coords).to(torch.int32), vals,
                        fwd.dim)


def compact_forward_index(index: "SeismicIndex") -> "SeismicIndex":
    """The index with its forward plane u8-quantized (per-doc affine
    scale and zero; u16 coords when ``dim < 65536``), as
    ``SeismicConfig.fwd_quant`` builds it. No-op on a compact index."""
    if index.fwd_scale is not None:
        return index
    q, scale, zero = quantize_u8(index.fwd.vals.to(torch.float32))
    coords = widen_coords(index.fwd.coords).to(torch.int32)
    if index.dim < 65536:
        coords = coords.to(torch.int16).view(torch.uint16)
    fwd = PaddedSparse(coords, q, index.dim)
    cfg = dataclasses.replace(index.config, fwd_quant=True)
    return dataclasses.replace(index, fwd=fwd, fwd_scale=scale,
                               fwd_zero=zero, config=cfg)


def _drop_self(ids: torch.Tensor, start: int, degree: int,
               n_docs: int) -> torch.Tensor:
    """Per row: remove the row's own doc id and -1 padding, keep the first
    ``degree`` survivors in score order, sentinel-pad -> int32."""
    own = start + torch.arange(ids.shape[0], device=ids.device)[:, None]
    keep = (ids != own) & (ids >= 0)
    # a stable sort on "not kept" moves kept entries to the front in order
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    picked = ids.gather(1, order)[:, :degree]
    kept = keep.gather(1, order)[:, :degree]
    return torch.where(kept, picked, n_docs).to(torch.int32)


def build_doc_graph(index: "SeismicIndex", *, degree: int = 8,
                    build_params: SearchParams | None = None,
                    batch: int = 256,
                    compact_forward: bool = False) -> "SeismicIndex":
    """Attach a document kNN graph (``knn_ids`` int32 [N, degree]) to a
    built index and return the extended index.

    ``build_params`` defaults to a budget-policy search with
    ``k = degree + 1`` (the +1 absorbs the self match), cut 8 and
    block_budget 64. The corpus goes through the pipeline ``batch`` rows
    at a time."""
    from repro_torch.retrieval.pipeline import search_pipeline
    if degree <= 0:
        raise ValueError(f"degree must be positive, got {degree}")
    if build_params is None:
        build_params = SearchParams(k=degree + 1, cut=8, block_budget=64,
                                    policy="budget")
    elif build_params.k < degree + 1:
        raise ValueError(
            f"build_params.k={build_params.k} cannot yield degree="
            f"{degree} neighbors after dropping the self match")
    if compact_forward:
        index = compact_forward_index(index)
    n = index.n_docs
    queries = doc_queries(index)
    nbrs = torch.empty((n, degree), dtype=torch.int32, device=index.device)
    for s in range(0, n, batch):
        _, ids, _ = search_pipeline(index, queries[s:s + batch],
                                    build_params)
        nbrs[s:s + batch] = _drop_self(ids, s, degree, n)
    return dataclasses.replace(index, knn_ids=nbrs)
