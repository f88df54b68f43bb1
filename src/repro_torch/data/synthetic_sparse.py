"""Synthetic learned-sparse-embedding collections (port of
``repro.data.synthetic_sparse``).

Same configuration fields and the same distributions as the numpy
original: Zipf-like coordinate popularity over a shuffled vocabulary,
topics as Gumbel-top-k coordinate subsets with log-normal affinities,
rows mixing one or two topics, log-normal values scaled to a max of 3.

The numpy original builds a dense ``[n_rows, d]`` float64 logits array
(244 GB at 1M x 30522). Here rows are drawn on the device in chunks of
``chunk_rows`` from one ``torch.Generator``, so memory stays at a few
``[chunk_rows, d]`` float32 arrays. The draws are not bit-equal to
numpy's (another generator); tests feed both packages numpy data.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.sparse.ops import PaddedSparse


@dataclasses.dataclass(frozen=True)
class SyntheticSparseConfig:
    dim: int = 4096
    n_docs: int = 8192
    n_queries: int = 256
    doc_nnz: int = 96
    query_nnz: int = 32
    n_topics: int = 64
    topic_coords: int = 384       # candidate coords per topic
    zipf_a: float = 1.05
    value_sigma: float = 1.0      # log-normal sigma -> concentration
    doc_topic_mix: int = 2        # topics mixed per doc
    seed: int = 0


def _gumbel_topk(logits: torch.Tensor, nnz: int,
                 gen: torch.Generator) -> torch.Tensor:
    """One draw of ``nnz`` distinct indices per row, with probability
    proportional to exp(logits) (Gumbel top-k; -log Exp(1) is Gumbel)."""
    e = torch.empty_like(logits).exponential_(generator=gen)
    return torch.topk(logits - torch.log(e), nnz, dim=-1).indices


def _lognormal(shape, sigma: float, gen: torch.Generator,
               device) -> torch.Tensor:
    return torch.empty(shape, device=device).log_normal_(0.0, sigma,
                                                         generator=gen)


def make_collection(cfg: SyntheticSparseConfig = SyntheticSparseConfig(), *,
                    device=None, chunk_rows: int = 8192):
    """Returns (docs PaddedSparse, queries PaddedSparse, meta dict), all
    on ``device`` (CUDA unless given)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    d = cfg.dim
    ranks = torch.randperm(d, generator=gen, device=dev).to(torch.float32) + 1
    log_pop = -cfg.zipf_a * torch.log(ranks)          # log(1 / rank^a)
    topic_coords = _gumbel_topk(log_pop.expand(cfg.n_topics, d).contiguous(),
                                cfg.topic_coords, gen)          # [T, m]
    log_w = torch.log(_lognormal(topic_coords.shape, cfg.value_sigma, gen,
                                 dev))                          # [T, m]

    def _draw(n_rows: int, nnz: int, primary_scale: float):
        t1 = torch.randint(0, cfg.n_topics, (n_rows,), generator=gen,
                           device=dev)
        t2 = torch.randint(0, cfg.n_topics, (n_rows,), generator=gen,
                           device=dev)
        coords = torch.empty((n_rows, nnz), dtype=torch.int32, device=dev)
        vals = torch.empty((n_rows, nnz), dtype=torch.float32, device=dev)
        for s in range(0, n_rows, chunk_rows):
            a, b = t1[s:s + chunk_rows], t2[s:s + chunk_rows]
            logits = torch.full((a.shape[0], d), -torch.inf, device=dev)
            logits.scatter_reduce_(1, topic_coords[a],
                                   log_w[a] * primary_scale, "amax")
            if cfg.doc_topic_mix > 1:
                logits.scatter_reduce_(1, topic_coords[b],
                                       log_w[b] * primary_scale * 0.5,
                                       "amax")
            logits = torch.where(torch.isfinite(logits), logits, -30.0)
            c = _gumbel_topk(logits, nnz, gen)
            v = torch.exp(logits.gather(1, c)) \
                * _lognormal(c.shape, cfg.value_sigma * 0.5, gen, dev)
            v = v / torch.clamp_min(v.amax(dim=-1, keepdim=True), 1e-9) * 3.0
            coords[s:s + chunk_rows] = c.to(torch.int32)
            vals[s:s + chunk_rows] = v
        return coords, vals, t1

    doc_c, doc_v, doc_t = _draw(cfg.n_docs, cfg.doc_nnz, 1.0)
    q_c, q_v, q_t = _draw(cfg.n_queries, cfg.query_nnz, 1.3)
    meta = dict(doc_topics=doc_t, query_topics=q_t, config=cfg)
    return PaddedSparse(doc_c, doc_v, d), PaddedSparse(q_c, q_v, d), meta
