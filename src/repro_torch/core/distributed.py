"""Doc-sharded Seismic: sharded indexes, query fan-out and the top-k merge
(port of ``repro.core.distributed``).

The corpus is split into ``n_shards`` equal shards (zero-padded at the
tail); every shard owns a complete local index over its documents, built
with one config, so every plane has one shape across shards (the JAX
package stacks them on a leading shard axis; :class:`ShardedIndex` keeps
the shards side by side and ``shard(s)`` returns one). A query runs its
local search on every shard; each shard's top-k is globalized and its pad
hits masked (:func:`mask_shard_topk`), the per-shard ``[Q, k]`` (score,
global id) pairs are concatenated in shard order, and a stable descending
top-k (``lax.top_k``'s tie order) gives the global answer. Per-query
traffic is O(k * n_shards), independent of the corpus size.

* :func:`search_shards` does all of it in one process (every shard on one
  device): the reference the two distributed forms are held to.
* :func:`make_distributed_search` is the SPMD form over
  ``torch.distributed`` (the counterpart of the JAX package's
  ``shard_map``): one rank per mesh position, each holding its shard.
* ``serve.replica.ReplicaSeismicServer(mode="shard")`` is the
  thread-parallel form behind one admission queue.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.build import build_index
from repro_torch.core.types import SeismicConfig, SeismicIndex
from repro_torch.retrieval.params import SearchParams
from repro_torch.retrieval.pipeline import run_pipeline
from repro_torch.sparse.ops import PaddedSparse, top_k


def shard_collection(docs: PaddedSparse, n_shards: int) -> PaddedSparse:
    """Pad N to a multiple of ``n_shards`` and add a leading shard axis:
    ``[S, N/S, nnz]``.

    Pad rows are all-zero docs at the tail of the LAST shard; every merge
    over per-shard results must mask them (:func:`mask_shard_topk`): an
    all-zero doc that surfaces as a candidate scores exactly 0.0 under an
    out-of-range global id."""
    n = docs.n
    per = -(-n // n_shards)
    pad = per * n_shards - n
    coords = torch.nn.functional.pad(docs.coords, (0, 0, 0, pad))
    vals = torch.nn.functional.pad(docs.vals, (0, 0, 0, pad))
    return PaddedSparse(coords.reshape(n_shards, per, -1),
                        vals.reshape(n_shards, per, -1), docs.dim)


def mask_shard_topk(scores: torch.Tensor, ids: torch.Tensor,
                    fwd: PaddedSparse, shard_offset: int,
                    n_docs: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Globalize one shard's local top-k and mask pad hits to
    ``(-inf, -1)``, the invariant every cross-shard merge relies on.

    Pad rows are exactly the all-zero forward rows, so they are found from
    ``fwd``'s content (for any value dtype); ``n_docs`` (the live corpus
    size) also masks any global id at or past it. scores/ids ``[Q, kk]``
    (ids -1 where the shard found nothing), ``fwd`` the shard's forward
    plane ``[per_shard, nnz]``; returns (scores, int32 global ids)."""
    per_shard = fwd.coords.shape[0]
    live_row = (fwd.vals != 0).any(dim=-1)                  # [per_shard]
    pad_hit = ~live_row[ids.long().clamp(0, per_shard - 1)]
    gids = ids.to(torch.int32) + shard_offset
    dead = (ids < 0) | pad_hit
    if n_docs is not None:
        dead = dead | (gids >= n_docs)
    scores = torch.where(dead, -torch.inf, scores)
    gids = torch.where(dead, -1, gids)
    return scores, gids


@dataclasses.dataclass(frozen=True)
class ShardedIndex:
    """One local index per doc shard, every plane of one shape across
    shards; global id = shard * per_shard + local id. ``n_docs`` is the
    live corpus size (before padding)."""

    shards: tuple[SeismicIndex, ...]
    n_docs: int

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def per_shard(self) -> int:
        return self.shards[0].n_docs

    def shard(self, s: int) -> SeismicIndex:
        return self.shards[s]

    def nbytes(self) -> int:
        return sum(x.nbytes()["total"] for x in self.shards)


def build_sharded_index(docs: PaddedSparse, cfg: SeismicConfig,
                        n_shards: int, *, list_chunk: int = 32
                        ) -> ShardedIndex:
    """Build one local index per doc shard (one config, so one seed and
    one plane shape for all), on the collection's device."""
    sharded = shard_collection(docs, n_shards)
    shards = tuple(
        build_index(PaddedSparse(sharded.coords[s], sharded.vals[s],
                                 docs.dim), cfg, list_chunk=list_chunk)
        for s in range(n_shards))
    return ShardedIndex(shards=shards, n_docs=docs.n)


def merge_shard_topk(parts, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked per-shard (scores, global ids) ``[Q, kk]`` pairs, in shard
    order -> the global (scores, ids) ``[Q, k]``: a stable descending
    top-k over their concatenation (equal scores keep the lower shard,
    then the lower position)."""
    all_s = torch.cat([s for s, _ in parts], dim=1)
    all_g = torch.cat([g for _, g in parts], dim=1)
    top_s, pos = top_k(all_s, k)
    return top_s, all_g.gather(1, pos)


def search_shards(sharded: ShardedIndex, queries: PaddedSparse,
                  p: SearchParams
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every shard's local search in this process, masked, merged ->
    (scores [Q, k], global ids int32 [Q, k], docs_evaluated int32 [Q]
    summed over shards)."""
    parts, ev = [], None
    for s, local in enumerate(sharded.shards):
        scores, ids, e = run_pipeline(local, queries.coords, queries.vals, p)
        parts.append(mask_shard_topk(scores, ids, local.fwd,
                                     s * sharded.per_shard,
                                     n_docs=sharded.n_docs))
        ev = e if ev is None else ev + e
    top_s, top_g = merge_shard_topk(parts, p.k)
    return top_s, top_g, ev


def _all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """All-gather ``t`` over ``group`` in group-rank order; over gloo the
    exchange goes through host memory (gloo gathers CPU tensors)."""
    import torch.distributed as dist
    dev = t.device
    comm = t.cpu() if dist.get_backend(group) == "gloo" else t
    out = [torch.empty_like(comm) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, comm.contiguous(), group=group)
    return [o.to(dev) for o in out]


def make_distributed_search(mesh, p: SearchParams,
                            doc_axes=("model",), data_axis="data",
                            *, n_docs: int | None = None):
    """Returns ``search(index, q_coords, q_vals) -> (scores, ids)``, run by
    every rank of ``mesh`` (a ``torch.distributed.DeviceMesh`` with a
    ``data_axis`` and the ``doc_axes``).

    ``index`` is this rank's shard: shard ``s``, the rank's position over
    ``doc_axes`` in row-major order. ``q_coords``/``q_vals`` are the
    whole ``[Q, nnz]`` batch on every rank (Q a multiple of the data
    axis's size): each rank searches the slice at its ``data_axis``
    position on its shard, globalizes and masks its top-k
    (:func:`mask_shard_topk`; ``n_docs`` the live corpus size, optional),
    all-gathers the ``[Ql, k]`` (score, global id) pairs over the doc axes
    one axis after another (as the JAX package's ``all_gather`` loop
    does; over one doc axis that is shard order) and takes a stable
    descending top-k. The slices are then all-gathered over the data
    axis, so every rank returns the whole ``(scores [Q, k], ids [Q, k])``.
    The caller picks the backend: over gloo the exchanges go through host
    memory."""
    names = tuple(mesh.mesh_dim_names)
    shape = tuple(mesh.mesh.shape)

    def size(ax):
        return shape[names.index(ax)]

    def search(local: SeismicIndex, q_coords: torch.Tensor,
               q_vals: torch.Tensor):
        shard_id = 0
        for ax in doc_axes:
            shard_id = shard_id * size(ax) + mesh.get_local_rank(ax)
        n_data = size(data_axis)
        if q_coords.shape[0] % n_data:
            raise ValueError(f"{q_coords.shape[0]} queries do not split "
                             f"over the {n_data} positions of "
                             f"{data_axis!r}")
        ql = q_coords.shape[0] // n_data
        a = mesh.get_local_rank(data_axis) * ql
        scores, ids, _ = run_pipeline(local, q_coords[a:a + ql],
                                      q_vals[a:a + ql], p)
        scores, gids = mask_shard_topk(scores, ids, local.fwd,
                                       shard_id * local.n_docs,
                                       n_docs=n_docs)
        all_s, all_g = scores, gids
        for ax in doc_axes:
            group = mesh.get_group(ax)
            all_s = torch.cat(_all_gather(all_s, group), dim=1)
            all_g = torch.cat(_all_gather(all_g, group), dim=1)
        top_s, pos = top_k(all_s, p.k)
        top_g = all_g.gather(1, pos)
        group = mesh.get_group(data_axis)
        return (torch.cat(_all_gather(top_s, group), dim=0),
                torch.cat(_all_gather(top_g, group), dim=0))

    return search


__all__ = ["ShardedIndex", "shard_collection", "mask_shard_topk",
           "build_sharded_index", "merge_shard_topk", "search_shards",
           "make_distributed_search"]
