"""Synchronous retrieval serving facade (port of the ``SeismicServer``
part of ``repro.serve.engine``; telemetry, observability, auditing and
index mutation are not ported yet).

Params are checked against the index (route, refine) before the first
launch."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import SeismicIndex
from repro_torch.retrieval import SearchParams, search_pipeline
from repro_torch.retrieval.pipeline import validate_params
from repro_torch.sparse.ops import PaddedSparse


@dataclasses.dataclass
class RetrievalResult:
    ids: torch.Tensor              # int32 [n, k], -1 padding
    scores: torch.Tensor           # f32 [n, k]
    docs_evaluated: torch.Tensor   # int32 [n]


class SeismicServer:
    """Fixed-batch retrieval front end over the shared pipeline: pads each
    request batch to a multiple of ``max_batch`` and answers it
    ``max_batch`` queries at a time, so every launch has one shape."""

    def __init__(self, index: SeismicIndex, params: SearchParams,
                 max_batch: int = 256):
        validate_params(index, params)      # fail before the first launch
        self.index = index
        self.params = params
        self.max_batch = max_batch

    def search(self, queries: PaddedSparse) -> RetrievalResult:
        k, dev = self.params.k, self.index.device
        n = queries.coords.shape[0]
        if n == 0:
            return RetrievalResult(
                ids=torch.zeros((0, k), dtype=torch.int32, device=dev),
                scores=torch.zeros((0, k), dtype=torch.float32, device=dev),
                docs_evaluated=torch.zeros((0,), dtype=torch.int32,
                                           device=dev))
        pad = (-n) % self.max_batch
        coords = torch.nn.functional.pad(queries.coords, (0, 0, 0, pad))
        vals = torch.nn.functional.pad(queries.vals, (0, 0, 0, pad))
        outs = [search_pipeline(self.index,
                                PaddedSparse(coords[s:s + self.max_batch],
                                             vals[s:s + self.max_batch],
                                             queries.dim), self.params)
                for s in range(0, n + pad, self.max_batch)]
        scores, ids, ev = (torch.cat(parts)[:n] for parts in zip(*outs))
        return RetrievalResult(ids=ids, scores=scores, docs_evaluated=ev)
