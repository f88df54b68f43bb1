"""The benchmark's own synthetic learned-sparse collection generator.

A frozen copy of the distributions of the port's
``repro_torch.data.synthetic_sparse.make_collection``, in plain torch, so
that a later change to the program cannot change the data it is measured
on: Zipf-like coordinate popularity over a shuffled vocabulary, topics as
Gumbel-top-k coordinate subsets with log-normal affinities, rows mixing
one or two topics (the second at half weight), log-normal values scaled
to a row maximum of 3. Queries use the same topics with their affinities
sharpened by 1.3.

The vocabulary's popularity order and the topics are the deployment's
term statistics: they are drawn once from ``topics_seed`` (a key of the
spec), so every run sees the same ones. The run's seed draws the
documents and the queries, each topic as often as every other (only the
order of the topics varies with the seed, so every seed asks for the
same work). Rows are drawn on the device from one
``torch.Generator`` in chunks of
``chunk_rows``; a chunk holds a few ``[chunk_rows, dim]`` float32 arrays
(about 4 GiB each at 32,768 rows of 30,522), so the draw is a few hundred
large calls. The same seed and spec give the same collection on the same
device type.
"""
from __future__ import annotations

import dataclasses

import torch

# the generator's defaults, as the port's SyntheticSparseConfig states them
DEFAULTS = dict(n_topics=64, topic_coords=384, zipf_a=1.05, value_sigma=1.0,
                doc_topic_mix=2, topics_seed=0)
QUERY_SCALE = 1.3          # queries' topic affinities, sharpened


@dataclasses.dataclass(frozen=True)
class Collection:
    """Documents and the query pool, padded-sparse (int32 coordinates,
    float32 values, no padding: every row has exactly ``nnz`` distinct
    coordinates with positive values)."""

    doc_coords: torch.Tensor    # int32 [n_docs, doc_nnz]
    doc_vals: torch.Tensor      # f32   [n_docs, doc_nnz]
    q_coords: torch.Tensor      # int32 [n_queries, query_nnz]
    q_vals: torch.Tensor        # f32   [n_queries, query_nnz]
    dim: int


def _gumbel_topk(logits: torch.Tensor, nnz: int,
                 gen: torch.Generator) -> torch.Tensor:
    """``nnz`` distinct indices per row, drawn with probability
    proportional to exp(logits) (-log Exp(1) is Gumbel)."""
    e = torch.empty_like(logits).exponential_(generator=gen)
    return torch.topk(logits - torch.log(e), nnz, dim=-1).indices


def _lognormal(shape, sigma: float, gen: torch.Generator,
               device) -> torch.Tensor:
    return torch.empty(shape, device=device).log_normal_(0.0, sigma,
                                                         generator=gen)


def _balanced(n: int, k: int, gen: torch.Generator, dev) -> torch.Tensor:
    """``n`` topic ids with each of ``k`` topics ``n // k`` or ``n // k +
    1`` times, in an order drawn from ``gen``: every seed sends the same
    mix of topics."""
    return (torch.arange(n, device=dev) % k)[
        torch.randperm(n, generator=gen, device=dev)]


def make_collection(spec: dict, n_queries: int, seed: int, device,
                    chunk_rows: int = 32768) -> Collection:
    """Draw ``spec["n_docs"]`` documents and ``n_queries`` queries of
    dimension ``spec["dim"]`` from ``seed`` on ``device``. ``spec`` holds
    ``dim``, ``n_docs``, ``doc_nnz``, ``query_nnz`` and optionally the
    keys of ``DEFAULTS``."""
    s = {**DEFAULTS, **spec}
    dev = torch.device(device)
    d, n_topics = s["dim"], s["n_topics"]
    gen = torch.Generator(device=dev).manual_seed(s["topics_seed"])
    ranks = torch.randperm(d, generator=gen, device=dev).to(torch.float32) + 1
    log_pop = -s["zipf_a"] * torch.log(ranks)
    topic_coords = _gumbel_topk(log_pop.expand(n_topics, d).contiguous(),
                                s["topic_coords"], gen)          # [T, m]
    log_w = torch.log(_lognormal(topic_coords.shape, s["value_sigma"], gen,
                                 dev))                           # [T, m]
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))

    def draw(n_rows: int, nnz: int, primary_scale: float):
        t1 = _balanced(n_rows, n_topics, gen, dev)
        t2 = _balanced(n_rows, n_topics, gen, dev)
        coords = torch.empty((n_rows, nnz), dtype=torch.int32, device=dev)
        vals = torch.empty((n_rows, nnz), dtype=torch.float32, device=dev)
        for a in range(0, n_rows, chunk_rows):
            ta, tb = t1[a:a + chunk_rows], t2[a:a + chunk_rows]
            logits = torch.full((ta.shape[0], d), -torch.inf, device=dev)
            logits.scatter_reduce_(1, topic_coords[ta],
                                   log_w[ta] * primary_scale, "amax")
            if s["doc_topic_mix"] > 1:
                logits.scatter_reduce_(1, topic_coords[tb],
                                       log_w[tb] * primary_scale * 0.5,
                                       "amax")
            logits = torch.where(torch.isfinite(logits), logits, -30.0)
            c = _gumbel_topk(logits, nnz, gen)
            v = torch.exp(logits.gather(1, c)) \
                * _lognormal(c.shape, s["value_sigma"] * 0.5, gen, dev)
            v = v / torch.clamp_min(v.amax(dim=-1, keepdim=True), 1e-9) * 3.0
            coords[a:a + chunk_rows] = c.to(torch.int32)
            vals[a:a + chunk_rows] = v
            del logits, c, v
        return coords, vals

    doc_c, doc_v = draw(s["n_docs"], s["doc_nnz"], 1.0)
    q_c, q_v = draw(n_queries, s["query_nnz"], QUERY_SCALE)
    return Collection(doc_c, doc_v, q_c, q_v, d)
