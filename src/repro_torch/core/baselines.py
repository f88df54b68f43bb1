"""Baseline retrieval systems the paper compares against (§7.1), in torch
on the collection's device (port of ``repro.core.baselines``).

* ``exact_search``   brute-force MIPS over the forward index in float32
                     (PISA's role: the exact, rank-safe reference).
* ``IvfIndex``       SparseIvf [Bruch et al. '23]: documents clustered once
                     globally (k-means with max-IP assignment); a query
                     probes the ``nprobe`` closest centroids and exactly
                     scores every doc in them.
* ``impact_search``  IOQP-style impact-ordered evaluation: each probed
                     coordinate contributes its top ``postings_per_list``
                     postings; partial scores accumulate score-at-a-time
                     in a dense accumulator and its top-k is returned.

The graph baseline is ``core.graph_baseline.IPNSWIndex`` (host numpy).

None of this is a port of a TPU kernel: the JAX package computes these
with XLA ops. Every top-k here keeps ``lax.top_k``'s order (descending,
equal values by ascending index). ``build_ivf`` never holds the dense
``[N, d]`` collection: inner products against the centroids are
gather-sums of centroid columns (``embedding_bag``), ``chunk`` documents
at a time, and the centroid sums are segment sums over the postings
stably sorted by (cluster, coordinate), each in document order, so two
builds are bitwise equal (a scatter-add would add in thread order).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.sparse.ops import PaddedSparse, densify, take_rows, top_k, \
    widen_coords

NEG = -torch.inf


def top_k_wide(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis of a wide 2-D ``x`` (no NaN)
    without sorting whole rows: the k-th largest value from
    ``torch.topk``, then every larger entry and the lowest-indexed entries
    equal to it, ordered by value (ties by index)."""
    if x.shape[-1] <= 8192:
        return top_k(x, k)
    kth = torch.topk(x, k, dim=-1).values[:, -1:]
    gt, eq = x > kth, x == kth
    need = k - gt.sum(dim=-1, keepdim=True)
    take = gt | (eq & (torch.cumsum(eq, dim=-1, dtype=torch.int32) <= need))
    pos = take.nonzero()[:, 1].reshape(x.shape[0], k)       # ascending
    s, o = top_k(x.gather(1, pos), k)
    return s, pos.gather(1, o)


def _q_dense(queries: PaddedSparse) -> torch.Tensor:
    return densify(queries, dtype=torch.float32)


def _dots(q: torch.Tensor, coords: torch.Tensor,
          vals: torch.Tensor) -> torch.Tensor:
    """<q_i, x_ij> for queries q [Q, d] and rows coords/vals [Q, M, nnz]
    -> f32 [Q, M]."""
    qn, m, nnz = coords.shape
    g = q.gather(1, widen_coords(coords).reshape(qn, m * nnz))
    return (g.reshape(qn, m, nnz) * vals.to(torch.float32)).sum(dim=-1)


# --------------------------------------------------------------------------
# Exact search (PISA reference point)
# --------------------------------------------------------------------------

def exact_search(docs: PaddedSparse, queries: PaddedSparse, k: int, *,
                 doc_chunk: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Brute-force MIPS, batched, in float32: every query against every
    doc, ``doc_chunk`` docs at a time with a running top-k. Returns
    (scores [Q, k], ids int32 [Q, k])."""
    q = _q_dense(queries)
    qn, n, nnz = q.shape[0], docs.n, docs.nnz_max
    if doc_chunk is None:       # keep the [Q, chunk, nnz] gather near 512 MB
        doc_chunk = max(k, (1 << 29) // max(qn * nnz * 8, 1))
    best_s = q.new_empty((qn, 0))
    best_i = torch.empty((qn, 0), dtype=torch.int64, device=q.device)
    for s in range(0, n, doc_chunk):
        c = docs.coords[s:s + doc_chunk]
        v = docs.vals[s:s + doc_chunk]
        scores = (q[:, widen_coords(c)] * v.to(torch.float32)).sum(dim=-1)
        ids = torch.arange(s, s + c.shape[0], device=q.device)
        cat_s = torch.cat([best_s, scores], dim=1)
        cat_i = torch.cat([best_i, ids.expand(qn, -1)], dim=1)
        best_s, pos = top_k_wide(cat_s, min(k, cat_s.shape[1]))
        best_i = cat_i.gather(1, pos)
    return best_s, best_i.to(torch.int32)


# --------------------------------------------------------------------------
# SparseIvf-style IVF
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IvfIndex:
    fwd: PaddedSparse
    centroids: torch.Tensor      # f32 [C, d]
    member_docs: torch.Tensor    # int32 [C, cap] (N = pad)
    member_len: torch.Tensor     # int32 [C]
    cap: int = 0

    def nbytes(self) -> int:
        return sum(t.nbytes for t in (self.centroids, self.member_docs,
                                      self.member_len))


def ivf_init(n: int, n_clusters: int, seed: int = 0,
             device=None) -> torch.Tensor:
    """The initial centroids' doc ids: ``jax.random.choice(PRNGKey(seed),
    n, (n_clusters,), replace=False)``, drawn on ``device`` (default the
    current CUDA device)."""
    return prng.choice(prng.key(seed, resolve_device(device)), n,
                       (n_clusters,), replace=False)


def _assign(docs: PaddedSparse, cent: torch.Tensor,
            chunk: int) -> torch.Tensor:
    """argmax_c <x_n, cent_c> for every doc (lowest c among ties), the
    inner products as gather-sums of centroid columns."""
    cent_t = cent.t().contiguous()                          # [d, C]
    out = torch.empty(docs.n, dtype=torch.int64, device=cent.device)
    for s in range(0, docs.n, chunk):
        c = widen_coords(docs.coords[s:s + chunk])
        v = docs.vals[s:s + chunk].to(torch.float32)
        ips = torch.nn.functional.embedding_bag(
            c, cent_t, per_sample_weights=v, mode="sum")     # [chunk, C]
        out[s:s + chunk] = ips.argmax(dim=-1)
    return out


def _cluster_sums(docs: PaddedSparse, assign: torch.Tensor,
                  n_clusters: int) -> torch.Tensor:
    """Sum of each cluster's documents, dense f32 [C, d]: the postings
    keyed by (cluster, coordinate), stably sorted, summed key by key."""
    d = docs.dim
    key = (assign[:, None] * d + widen_coords(docs.coords)).reshape(-1)
    key, order = torch.sort(key, stable=True)
    vals = docs.vals.to(torch.float32).reshape(-1)[order]
    del order
    uniq, counts = torch.unique_consecutive(key, return_counts=True)
    del key
    sums = torch.zeros((n_clusters * d,), dtype=torch.float32,
                       device=docs.device)
    sums[uniq] = torch.segment_reduce(vals, "sum", lengths=counts)
    return sums.reshape(n_clusters, d)


def build_ivf(docs: PaddedSparse, n_clusters: int, cap: int,
              iters: int = 3, seed: int = 0, *,
              chunk: int = 32768) -> IvfIndex:
    """K-means (Lloyd, dense centroids) with max-IP assignment, as
    SparseIvf clusters; members capacity-padded with the sentinel N.
    The initial centroids are the docs :func:`ivf_init` draws; each
    iteration assigns every doc, then moves each centroid to the mean of
    its docs (an empty cluster keeps its centroid). Members come from the
    last iteration's assignment."""
    n, dev = docs.n, docs.device
    init = ivf_init(n, n_clusters, seed, dev)
    cent = densify(docs[init], dtype=torch.float32)         # [C, d]
    assign = None
    for _ in range(iters):
        assign = _assign(docs, cent, chunk)
        cnt = torch.bincount(assign, minlength=n_clusters).to(
            torch.float32)[:, None]
        cent = torch.where(cnt > 0, _cluster_sums(docs, assign, n_clusters)
                           / torch.clamp_min(cnt, 1.0), cent)
    order = torch.sort(assign, stable=True).indices
    sorted_assign = assign[order]
    ar = torch.arange(n_clusters, device=dev)
    start = torch.searchsorted(sorted_assign, ar)
    ln = torch.searchsorted(sorted_assign, ar + 1) - start
    slot = torch.arange(cap, device=dev)[None, :]
    idx = (start[:, None] + slot).clamp(0, n - 1)
    member = torch.where(slot < torch.clamp_max(ln, cap)[:, None],
                         order[idx], n)
    return IvfIndex(fwd=docs, centroids=cent,
                    member_docs=member.to(torch.int32),
                    member_len=ln.to(torch.int32), cap=cap)


def ivf_search(index: IvfIndex, queries: PaddedSparse, k: int,
               nprobe: int, *, query_chunk: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe the ``nprobe`` max-IP centroids and exactly score their
    members -> (scores [Q, k], ids int32 [Q, k] with -1 padding, docs
    evaluated int32 [Q])."""
    fwd = index.fwd
    n = fwd.n
    m = nprobe * index.cap
    if query_chunk is None:     # the [Qc, m, nnz] gather near 512 MB
        query_chunk = max(1, (1 << 29) // (m * fwd.nnz_max * 12))
    out_s, out_i, out_e = [], [], []
    for a in range(0, queries.n, query_chunk):
        q = _q_dense(queries[a:a + query_chunk])
        cs = q @ index.centroids.t()                        # [Qc, C]
        _, probe = top_k(cs, nprobe)
        cand = index.member_docs[probe].reshape(q.shape[0], -1)
        safe = cand.long().clamp(0, n - 1)
        s = _dots(q, take_rows(fwd.coords, safe), fwd.vals[safe])
        live = cand < n
        s = torch.where(live, s, NEG)
        top_s, pos = top_k(s, k)
        ids = torch.where(torch.isfinite(top_s), cand.gather(1, pos), -1)
        out_s.append(top_s)
        out_i.append(ids.to(torch.int32))
        out_e.append(live.sum(dim=-1).to(torch.int32))
    return torch.cat(out_s), torch.cat(out_i), torch.cat(out_e)


# --------------------------------------------------------------------------
# IOQP-style impact-ordered, budgeted score-at-a-time
# --------------------------------------------------------------------------

def impact_search(list_docs: torch.Tensor, list_vals: torch.Tensor,
                  list_len: torch.Tensor, n_docs: int,
                  queries: PaddedSparse, k: int, postings_per_list: int, *,
                  query_chunk: int = 64
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Score-at-a-time over impact-ordered lists with a per-list budget
    (IOQP's ``fraction`` knob ~ postings_per_list / lam): the probed
    lists' postings are re-sorted by value (stable), the first
    ``postings_per_list`` of each add ``q_i * x_i`` into a dense
    ``[N + 1]`` accumulator per query (slot N takes the sentinels), list
    by list in query order, as XLA applies the JAX package's scatter; a
    list's ids are distinct, so each list is one deterministic
    ``scatter_add_``. Returns (scores [Q, k], ids [Q, k])."""
    lam = list_docs.shape[1]
    b = min(postings_per_list, lam)
    out_s, out_i = [], []
    for a in range(0, queries.n, query_chunk):
        qc = widen_coords(queries.coords[a:a + query_chunk])
        qv = queries.vals[a:a + query_chunk].to(torch.float32)
        docs = list_docs[qc]                                # [Qc, nnz, lam]
        vals = list_vals[qc].to(torch.float32)
        order = torch.sort(-vals, dim=-1, stable=True).indices[..., :b]
        docs_b = docs.gather(-1, order).long().clamp(0, n_docs)
        contrib = vals.gather(-1, order) * qv[..., None]
        contrib = torch.where(qv[..., None] > 0, contrib, 0.0)
        acc = torch.zeros((qc.shape[0], n_docs + 1), dtype=torch.float32,
                          device=qc.device)
        for i in range(qc.shape[1]):
            acc.scatter_add_(1, docs_b[:, i], contrib[:, i])
        s, ids = top_k_wide(acc[:, :n_docs], k)
        out_s.append(s)
        out_i.append(ids.to(torch.int32))
    return torch.cat(out_s), torch.cat(out_i)


__all__ = ["exact_search", "IvfIndex", "ivf_init", "build_ivf",
           "ivf_search", "impact_search", "top_k_wide"]
