"""Seismic index construction (port of ``repro.core.build``).

Algorithm 1 per coordinate i (one inverted list):
  1. static pruning  — keep the lam docs with the largest x_i (§5.1)
  2. geometric blocking — shallow K-Means: beta sampled members are the
     representatives; every member goes to its max-inner-product
     representative (§5.2)
  3. physical blocks — contiguous runs after the cluster permutation,
     split at ``block_cap`` boundaries
  4. summaries — coordinate-wise max per block (Eq. 2; or the centroid),
     alpha-mass pruned (Def. 3.1), 8-bit quantized (§5.3)
  5. superblocks (``superblock_fanout > 0``) — every ``fanout``
     consecutive blocks get one summary, the coordinate-wise max of the
     children's dequantized summaries, round-up requantized, so it
     upper-bounds each child for any nonnegative query

Lists are processed ``list_chunk`` at a time, all lists of a chunk in
one batch of tensor ops. Nothing ``[lam, nnz, beta]``-shaped and no
dense ``[n_blocks, d]`` (or ``[n_superblocks, d]``) row is ever made:
the assignment is one ``embedding_bag`` per chunk (a member is a bag of
its non-zeros' rows in a dense representative table), and a summary
sorts only its block's (or its children's) non-zeros.
"""
from __future__ import annotations

import math
import time
from typing import NamedTuple

import torch

from repro_torch import prng
from repro_torch.core.types import SeismicConfig, SeismicIndex
from repro_torch.sparse.ops import PaddedSparse, take_rows, widen_coords
from repro_torch.sparse.quant import (dequantize_u8, quantize_u8,
                                      quantize_u8_ceil)


# Postings the postings phase sorts at once: a range of consecutive
# coordinates holds at most this many plus one coordinate's. A range's
# positions, keys, values and the stable sort's outputs and scratch come
# to about 60 bytes a posting (4 GB here); the whole collection's, sorted
# at once, would be 48 bytes a posting beside the collection.
POSTINGS_BUDGET = 1 << 26
_POSITION_CHUNK = 1 << 28      # positions scanned per elementwise pass


def _chunk_coords(coords: torch.Tensor) -> torch.Tensor:
    """A slice of the coordinate plane, comparable with Python ints."""
    return widen_coords(coords) if coords.dtype == torch.uint16 else coords


def _range_positions(coords, vals, lo: int, hi: int) -> torch.Tensor:
    """Flat positions (int64, ascending) of the live postings (val > 0)
    whose coordinate lies in [lo, hi)."""
    out = []
    for a in range(0, coords.numel(), _POSITION_CHUNK):
        c = _chunk_coords(coords[a:a + _POSITION_CHUNK])
        live = (c >= lo) & (c < hi) & (vals[a:a + _POSITION_CHUNK] > 0)
        out.append(live.nonzero().squeeze(1).add_(a))
    return torch.cat(out)


def _sorted_postings(docs: PaddedSparse, lam: int):
    """Each coordinate's top-``lam`` postings in (val desc, position asc)
    order, as ``lexsort((-v, c))`` of every (coord, val, doc) triple
    followed by a cut at ``lam`` would give. Padding entries (val <= 0)
    are no posting. Returns (vals, docs, starts, counts): the kept values
    and doc ids, coordinate c's at ``starts[c]`` onwards, ``min(counts[c],
    lam)`` of them; ``counts`` is each coordinate's whole posting count.

    The coordinates are cut into ranges of at most ``POSTINGS_BUDGET``
    postings (plus one coordinate's). Each range's postings are picked
    out in position order and sorted with ONE stable sort of an int64
    key: the coordinate in the high 32 bits, and below it the value's
    float32 bits counted down (a positive float's bits grow with its
    value). So the order is that of one stable sort of every posting,
    and the memory is the collection's and one range's."""
    coords, vals = docs.coords.reshape(-1), docs.vals.reshape(-1)
    nnz, d, dev = docs.coords.shape[1], docs.dim, docs.device
    counts = torch.zeros(d + 1, dtype=torch.int64, device=dev)
    for a in range(0, coords.numel(), _POSITION_CHUNK):
        c = widen_coords(coords[a:a + _POSITION_CHUNK])
        counts += torch.bincount(
            torch.where(vals[a:a + _POSITION_CHUNK] > 0, c, d),
            minlength=d + 1)
    counts = counts[:d]
    kept = counts.clamp(max=lam)
    starts = torch.cumsum(kept, 0) - kept
    total = int(kept.sum())
    out_v = torch.zeros(max(total, 1), dtype=torch.float32, device=dev)
    out_d = torch.zeros(max(total, 1), dtype=torch.int32, device=dev)
    host = counts.cpu()
    first = torch.cumsum(host, 0) - host           # postings before c
    rid = first // POSTINGS_BUDGET
    edges = (torch.nonzero(rid[1:] != rid[:-1]).squeeze(1) + 1).tolist()
    for lo, hi in zip([0] + edges, edges + [d]):
        if int(host[lo:hi].sum()) == 0:
            continue
        pos = _range_positions(coords, vals, lo, hi)
        v = vals[pos].to(torch.float32)
        key = widen_coords(take_rows(coords, pos)).bitwise_left_shift_(
            32).bitwise_or_(v.view(torch.int32).to(torch.int64).neg_()
                            .add_(0x7FFFFFFF))
        key, order = torch.sort(key, stable=True)
        c = key.bitwise_right_shift_(32)           # sorted coordinates
        rank = torch.arange(pos.numel(), device=dev) \
            - (first[lo:hi].to(dev) - int(first[lo]))[c - lo]
        keep = rank < lam
        src, c, rank = order[keep], c[keep], rank[keep]
        dst = starts[c] + rank
        out_v[dst] = v[src]
        out_d[dst] = (pos[src] // nnz).to(torch.int32)
        # freed before the next range is picked out, so one range is held
        del pos, v, key, order, src, c, rank, dst, keep
    return out_v, out_d, starts, counts


def _prune_list(lists, sorted_v, sorted_d, starts, counts, lam: int,
                n_docs: int):
    """Top-lam postings of the lists ``lists`` [Lc] out of the global
    sorted triples -> (docs [Lc, lam], vals [Lc, lam], cnt [Lc])."""
    cnt = counts[lists].clamp(max=lam)
    pos = torch.arange(lam, device=lists.device)
    idx = (starts[lists, None] + pos).clamp(0, max(sorted_d.numel() - 1, 0))
    valid = pos < cnt[:, None]
    docs = torch.where(valid, sorted_d[idx], n_docs)
    vals = torch.where(valid, sorted_v[idx], 0.0)
    return docs.to(torch.int32), vals, cnt.to(torch.int32)


def _assign_clusters(rep_pos, docs, cnt, fwd: PaddedSparse,
                     cfg: SeismicConfig) -> torch.Tensor:
    """Shallow K-Means over a chunk of pruned lists [Lc, lam]: each member
    goes to the representative maximizing <x, mu> (first one on ties);
    padding goes last (cluster ``beta``).

    Representatives of list l are its members at positions
    ``rep_pos[l]``; they fill rows ``l * d .. l * d + d - 1`` of a dense
    ``[Lc * d, beta]`` table. All members of the chunk go through ONE
    ``embedding_bag`` over that table: member (l, m) is the bag of rows
    ``l * d + coord`` of its non-zeros, weighted by their values. A bag
    sums its rows one after another in coordinate order, so the scores
    are the same on every run (cuSPARSE's CSR x dense product was not on
    CUDA, so two builds of one collection could assign differently)."""
    lc, lam = docs.shape
    beta, d, n = cfg.beta, fwd.dim, fwd.n
    dev = docs.device
    base = (torch.arange(lc, device=dev) * d)[:, None, None]
    rep_ids = docs.gather(1, rep_pos.clamp(0, lam - 1)).long().clamp(0, n - 1)
    rep_c = widen_coords(fwd.coords[rep_ids]) + base          # [Lc, beta, nnz]
    rep_b = torch.arange(beta, device=dev)[None, :, None].expand_as(rep_c)
    reps = torch.zeros((lc * d, beta), dtype=torch.float32, device=dev)
    reps.index_put_((rep_c.reshape(-1), rep_b.reshape(-1)),
                    fwd.vals[rep_ids].to(torch.float32).reshape(-1),
                    accumulate=True)
    member = docs.long().clamp(0, n - 1)
    mv = fwd.vals[member].to(torch.float32)                    # [Lc, lam, nnz]
    pos = torch.arange(lam, device=dev)
    member_live = pos < cnt[:, None]
    mv = torch.where(member_live[..., None], mv, 0.0)          # no padding
    key = torch.where(mv > 0, widen_coords(fwd.coords[member]), d)
    key, order = torch.sort(key, dim=-1)                       # coords asc
    mv = mv.gather(-1, order)
    live = key < d
    per_bag = live.sum(-1).reshape(-1)
    ips = torch.nn.functional.embedding_bag(
        (key + base)[live], reps, torch.cumsum(per_bag, 0) - per_bag,
        mode="sum", per_sample_weights=mv[live])              # [Lc*lam, beta]
    assign = ips.view(lc, lam, beta).argmax(dim=-1).to(torch.int32)
    return torch.where(member_live, assign, beta)              # padding last


def _physical_blocks(assign, cnt, cfg: SeismicConfig):
    """Stable-sort each list by cluster, then split runs at block_cap
    boundaries -> (perm, block_id, blk_off, blk_len), all [Lc, ...]."""
    lc, lam = assign.shape
    nb, dev = cfg.n_blocks, assign.device
    perm = torch.sort(assign, dim=-1, stable=True).indices
    sa = assign.gather(1, perm)
    pos = torch.arange(lam, device=dev).expand(lc, lam)
    prev = torch.cat([torch.full((lc, 1), -1, dtype=sa.dtype, device=dev),
                      sa[:, :-1]], dim=1)
    new_cluster = sa != prev
    cluster_start = torch.cummax(torch.where(new_cluster, pos, 0), 1).values
    live = pos < cnt[:, None]
    new_block = (new_cluster | ((pos - cluster_start) % cfg.block_cap == 0)) \
        & live
    block_id = torch.cumsum(new_block.to(torch.int32), dim=1) - 1
    block_id = torch.where(live, block_id, nb)
    blk_len = torch.zeros((lc, nb + 1), dtype=torch.int64, device=dev)
    blk_len.scatter_add_(1, block_id.clamp(0, nb).long(),
                         torch.ones_like(block_id, dtype=torch.int64))
    blk_len = blk_len[:, :nb]
    blk_off = torch.cumsum(blk_len, dim=1) - blk_len
    return perm, block_id.to(torch.int32), blk_off.to(torch.int32), \
        blk_len.to(torch.int32)


def _summaries(docs_perm, block_id, fwd: PaddedSparse, cfg: SeismicConfig,
               fused: bool = True):
    """Per-block summary of a chunk of lists -> (coords [Lc, nb, S],
    u8 [Lc, nb, S], scale [Lc, nb], zero [Lc, nb]). ``fused`` rounds the
    quantizer's scale as the compiled JAX build does (see
    :func:`list_block_arrays`).

    Equal to the JAX builder's dense route (scatter into ``[nb, d]``,
    then ``alpha_mass_subvector`` over ``arange(d)``) without the dense
    rows: the block's non-zeros are sorted by (block, -value, coord);
    the zero entries of the dense row follow in ascending coordinate
    order, which matters when they are kept (an empty block, or
    ``alpha >= 1``). Prefix sums are taken in float64 and rounded to
    float32, so the keep boundary can differ from the JAX builder's
    float32 cumsum only where ``alpha * total`` lies within rounding of a
    prefix sum."""
    lc, lam = docs_perm.shape
    nb, d, s, n = cfg.n_blocks, fwd.dim, cfg.summary_nnz, fwd.n
    dev = docs_perm.device
    nblk = lc * nb
    member = docs_perm.long().clamp(0, n - 1)
    blk = torch.arange(lc, device=dev)[:, None] * nb + block_id.long()
    in_block = (docs_perm < n) & (block_id < nb)               # [Lc, lam]
    dv = fwd.vals[member].to(torch.float32)                    # [Lc, lam, nnz]
    take = (dv > 0) & in_block[..., None]
    key = (blk[..., None] * d + widen_coords(fwd.coords[member]))[take]
    ukey, inv = torch.unique(key, return_inverse=True)
    uval = torch.zeros(ukey.numel(), dtype=torch.float32, device=dev)
    if cfg.summary_kind == "centroid":
        uval.index_add_(0, inv, dv[take])
        members = torch.bincount(blk[in_block], minlength=nblk)
        uval = uval / torch.clamp_min(members[ukey // d].to(torch.float32),
                                      1.0)
    else:   # "max": the conservative Eq. 2 bound
        uval.scatter_reduce_(0, inv, dv[take], "amax", include_self=True)
    order = torch.sort(-uval, stable=True).indices
    order = order[torch.sort(ukey[order] // d, stable=True).indices]
    sb = ukey[order] // d                                      # block
    sc = ukey[order] - sb * d                                  # coord
    sv = uval[order]                                           # value
    m = torch.bincount(sb, minlength=nblk)                     # nnz per block
    start = torch.cumsum(m, 0) - m
    rank = torch.arange(sb.numel(), device=dev) - start[sb]
    c64 = torch.cumsum(sv.to(torch.float64), 0)
    block_base = (c64 - sv.to(torch.float64))[start[sb]]
    cum = (c64 - block_base).to(torch.float32)                 # in-block prefix
    total = torch.zeros(nblk, dtype=torch.float32, device=dev)
    has = m > 0
    total[has] = cum[(start + m - 1)[has]]
    thresh = cfg.alpha * total
    sel = ((cum <= thresh[sb]) | (rank == 0)) & (rank < s)
    out_c = torch.zeros((nblk, s), dtype=torch.int32, device=dev)
    out_v = torch.zeros((nblk, s), dtype=torch.float32, device=dev)
    out_c[sb[sel], rank[sel]] = sc[sel].to(torch.int32)
    out_v[sb[sel], rank[sel]] = sv[sel]
    # zero entries of the dense row: kept iff total <= alpha * total; the
    # j-th one is the j-th coordinate outside the support (< m + S)
    fill = (total <= thresh) & (m < s)
    w = min(2 * s, d)
    outside = torch.ones((nblk, w), dtype=torch.bool, device=dev)
    near = sc < w
    outside[sb[near], sc[near]] = False
    slot = m[:, None] + torch.cumsum(outside.to(torch.int64), 1) - 1
    put = outside & (slot < s) & fill[:, None]
    bi, ci = put.nonzero(as_tuple=True)
    out_c[bi, slot[bi, ci]] = ci.to(torch.int32)
    q, scale, zero = quantize_u8(out_v, by_reciprocal=fused)
    return (out_c.view(lc, nb, s), q.view(lc, nb, s), scale.view(lc, nb),
            zero.view(lc, nb))


def _top_per_group(group, coords, vals, n_groups: int, width: int,
                   dim: int):
    """The coordinate-wise max of entries (group, coordinate, value > 0),
    then each group's ``width`` largest in ``lax.top_k`` order over a
    dense ``[dim]`` row (value desc, coordinate asc), without the dense
    rows: unique (group, coordinate) keys, one sort. The row's zeros
    would follow and are written as coordinate 0, value 0 -> (coords
    int32 [G, width], values f32 [G, width])."""
    dev = vals.device
    key = group.to(torch.int64) * dim + coords.to(torch.int64)
    ukey, inv = torch.unique(key, return_inverse=True)
    uval = torch.zeros(ukey.numel(), dtype=torch.float32, device=dev)
    uval.scatter_reduce_(0, inv, vals, "amax", include_self=True)
    order = torch.sort(-uval, stable=True).indices
    order = order[torch.sort(ukey[order] // dim, stable=True).indices]
    sg = ukey[order] // dim                                    # group
    m = torch.bincount(sg, minlength=n_groups)
    rank = torch.arange(sg.numel(), device=dev) - (torch.cumsum(m, 0)
                                                   - m)[sg]
    keep = rank < width
    out_c = torch.zeros((n_groups, width), dtype=torch.int32, device=dev)
    out_v = torch.zeros((n_groups, width), dtype=torch.float32, device=dev)
    out_c[sg[keep], rank[keep]] = (ukey[order] - sg * dim)[keep].to(
        torch.int32)
    out_v[sg[keep], rank[keep]] = uval[order][keep]
    return out_c, out_v


def _dequantize(q, scale, zero, fused: bool) -> torch.Tensor:
    """Summary values in float32. ``fused``: rounded once, as a fused
    multiply-add does it (the JAX build's compiled dequant is one; so is
    the kernels'): the float64 product (q - 1) * scale is exact and the
    sum is rounded to float32. Otherwise the product and the sum are each
    rounded, as eager JAX (and eager torch) compute them."""
    if not fused:
        return dequantize_u8(q, scale, zero)
    return dequantize_u8(q, scale.double(), zero.double(),
                         dtype=torch.float64).to(torch.float32)


def _superblock_summaries(sc, q, scale, zero, dim: int, cfg: SeismicConfig,
                          fused: bool = True):
    """Coarse tier over a chunk of lists' quantized block summaries
    ([Lc, nb, S] and [Lc, nb]) -> (coords [Lc, ns, S2], u8 [Lc, ns, S2],
    scale [Lc, ns], zero [Lc, ns]), with S2 = min(fanout * S, d).

    Block j belongs to superblock j // fanout. Equal to the JAX
    build_index's dense route (scatter-max of the dequantized children
    into a ``[ns, d]`` row, ``lax.top_k`` of width S2, coordinate 0 where
    the value is 0) without the dense rows (:func:`_top_per_group`)."""
    lc, nb, s = q.shape
    f, ns = cfg.superblock_fanout, cfg.n_superblocks
    s2 = min(cfg.superblock_nnz, dim)
    dev = q.device
    v = _dequantize(q, scale, zero, fused)                     # [Lc, nb, S]
    group = (torch.arange(lc, device=dev)[:, None] * ns
             + torch.arange(nb, device=dev)[None, :] // f)     # [Lc, nb]
    take = v > 0
    out_c, out_v = _top_per_group(group[..., None].expand_as(sc)[take],
                                  sc[take], v[take], lc * ns, s2, dim)
    q2, scale2, zero2 = quantize_u8_ceil(out_v, by_reciprocal=fused)
    return (out_c.view(lc, ns, s2), q2.view(lc, ns, s2),
            scale2.view(lc, ns), zero2.view(lc, ns))


def list_block_arrays(docs, vals, cnt, fwd: PaddedSparse,
                      cfg: SeismicConfig, rep_pos=None, tick=None,
                      fused: bool = True):
    """Cluster + block + summarize a chunk of pruned lists [Lc, lam]:
    the per-list half of Algorithm 1 after static pruning. ``rep_pos``
    [Lc, beta] holds the representatives' positions (geometric blocking
    only). ``tick(phase)`` is called after each phase. With
    ``superblock_fanout > 0`` the superblock tier's four arrays follow
    the nine flat ones.

    ``fused`` rounds as the JAX package's compiled ``build_index``: XLA
    divides by 254 as a multiply by its reciprocal, and the superblock
    dequant is one multiply-add. ``fused=False`` rounds as the same
    functions called eagerly, as the JAX ``mutate.compact`` calls them:
    a division, and a dequant rounded after the product and the sum."""
    tick = tick or (lambda phase: None)
    if cfg.blocking == "fixed":
        # Fig. 5 baseline: impact-ordered chunks of one cluster
        pos = torch.arange(cfg.lam, device=docs.device)
        assign = torch.where(pos < cnt[:, None], 0, cfg.beta).to(torch.int32)
    else:
        assign = _assign_clusters(rep_pos, docs, cnt, fwd, cfg)
    tick("assign")
    perm, block_id, blk_off, blk_len = _physical_blocks(assign, cnt, cfg)
    docs_perm = docs.gather(1, perm)
    vals_perm = vals.gather(1, perm)
    tick("blocks")
    sc, q, scale, zero = _summaries(docs_perm, block_id, fwd, cfg, fused)
    tick("summaries")
    out = (docs_perm, vals_perm, cnt, blk_off, blk_len, sc, q, scale, zero)
    if cfg.superblock_fanout > 0:
        out += _superblock_summaries(sc, q, scale, zero, fwd.dim, cfg,
                                     fused)
        tick("superblocks")
    return out


def block_summaries(docs_perm, block_id, fwd: PaddedSparse,
                    cfg: SeismicConfig):
    """Public seam over the per-block summary construction (Eq. 2 max ->
    alpha-mass -> u8) for a chunk of lists ([Lc, W] block-permuted doc
    ids and their block ids, ``n_blocks`` marking positions outside any
    block): compaction summarizes freshly appended tail blocks through
    the builder's own path. Rounds as the JAX seam called eagerly (a
    division by 254; see :func:`list_block_arrays`)."""
    return _summaries(docs_perm, block_id, fwd, cfg, fused=False)


def merge_superblock_summary(sup_coords, sup_q, sup_scale, sup_zero,
                             child_sc, child_q, child_scale, child_zero,
                             dim: int, cfg: SeismicConfig):
    """Monotone update of G superblock summaries with new child blocks:
    ``sup_*`` are [G, S2] and [G], ``child_*`` [G, m, S] and [G, m] (a
    child of level-0 entries only contributes nothing, so groups with
    fewer new children pad with them).

    The coordinate-wise max of the dequantized old summary and the new
    children, round-up requantized: the result upper-bounds every child
    of the group, the old ones through the old summary. Equal to the JAX
    seam's dense ``[dim]`` row and ``lax.top_k`` without the dense row
    (:func:`_top_per_group`), rounded as the JAX seam called eagerly (the
    dequant rounded after the product and the sum, a division by 254;
    see :func:`list_block_arrays`)."""
    g, s2 = sup_q.shape
    dev = sup_q.device
    old = _dequantize(sup_q, sup_scale, sup_zero, False)          # [G, S2]
    cv = _dequantize(child_q, child_scale, child_zero, False)     # [G, m, S]
    rows = torch.arange(g, device=dev)
    group = torch.cat([rows[:, None].expand_as(old).reshape(-1),
                       rows[:, None, None].expand_as(cv).reshape(-1)])
    coords = torch.cat([sup_coords.reshape(-1), child_sc.reshape(-1)])
    vals = torch.cat([old.reshape(-1), cv.reshape(-1)])
    take = vals > 0
    out_c, out_v = _top_per_group(group[take], coords[take], vals[take], g,
                                  s2, dim)
    q2, scale2, zero2 = quantize_u8_ceil(out_v)
    return out_c, q2, scale2, zero2


def sample_rep_pos(counts, cfg: SeismicConfig,
                   lists: torch.Tensor | None = None) -> torch.Tensor:
    """Representative positions [L, beta] of the lists ``lists`` (default
    ``0 .. L - 1``) whose postings number ``counts`` [L], uniform over
    each list's ``max(min(count, lam), 1)`` members (with replacement):
    the JAX builder's draws, list l's from ``randint(fold_in(PRNGKey(
    seed), l), (beta,), 0, max(cnt, 1))``. A list's row depends on its
    coordinate and count alone, on any device, so one list can be drawn
    again by itself."""
    if lists is None:
        lists = torch.arange(counts.shape[0], device=counts.device)
    hi = counts.clamp(max=cfg.lam).clamp(min=1)
    keys = prng.fold_in(prng.key(cfg.seed, counts.device), lists)
    return prng.randint(keys, (cfg.beta,), 0, hi[:, None])


class _Ticker:
    """Accumulates seconds per build phase into ``timings`` (syncing the
    device first), and on a CUDA device the allocator's peak bytes at the
    end of each phase under ``<phase>_peak_bytes``; a no-op when
    ``timings`` is None.

    The peak is ``torch.cuda.max_memory_allocated``, never reset here so
    that a caller's own reading stays whole: it is the peak over a phase
    wherever that phase raised it, and over the first phase (postings)
    the peak since the caller's last reset."""

    def __init__(self, timings: dict | None, device: torch.device):
        self.timings, self.device = timings, device
        self.last = self._now()

    def _now(self) -> float:
        if self.timings is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __call__(self, phase: str) -> None:
        if self.timings is None:
            return
        now = self._now()
        self.timings[phase] = self.timings.get(phase, 0.0) + now - self.last
        if self.device.type == "cuda":
            self.timings[f"{phase}_peak_bytes"] = \
                torch.cuda.max_memory_allocated(self.device)
        self.last = now


def build_index(docs: PaddedSparse, cfg: SeismicConfig = SeismicConfig(), *,
                list_chunk: int = 64, rep_pos: torch.Tensor | None = None,
                timings: dict | None = None) -> SeismicIndex:
    """Algorithm 1 over the whole collection, on the collection's device.

    ``rep_pos`` [dim, beta] fixes the representatives' positions
    (default: ``sample_rep_pos``, the JAX builder's draws from
    ``cfg.seed``). With ``timings`` given, seconds per phase accumulate
    into it, and on a CUDA device each phase's allocator peak
    (:class:`_Ticker`)."""
    dev, d, n = docs.device, docs.dim, docs.n
    lam, nb, s = cfg.lam, cfg.n_blocks, cfg.summary_nnz
    tick = _Ticker(timings, dev)
    fwd32 = docs.astype(torch.float32)
    sorted_v, sorted_d, starts, counts = _sorted_postings(docs, lam)
    if cfg.blocking != "fixed" and rep_pos is None:
        rep_pos = sample_rep_pos(counts, cfg)
    tick("postings")
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    list_docs = torch.empty((d, lam), **i32)
    list_vals = torch.empty((d, lam), **f32)
    list_len = torch.empty((d,), **i32)
    block_off = torch.empty((d, nb), **i32)
    block_len = torch.empty((d, nb), **i32)
    sum_coords = torch.empty((d, nb, s), **i32)
    sum_q = torch.empty((d, nb, s), dtype=torch.uint8, device=dev)
    sum_scale = torch.empty((d, nb), **f32)
    sum_zero = torch.empty((d, nb), **f32)
    planes = [list_docs, list_vals, list_len, block_off, block_len,
              sum_coords, sum_q, sum_scale, sum_zero]
    sup = {}
    if cfg.superblock_fanout > 0:
        ns, s2 = cfg.n_superblocks, min(cfg.superblock_nnz, d)
        sup = dict(sup_coords=torch.empty((d, ns, s2), **i32),
                   sup_q=torch.empty((d, ns, s2), dtype=torch.uint8,
                                     device=dev),
                   sup_scale=torch.empty((d, ns), **f32),
                   sup_zero=torch.empty((d, ns), **f32))
        planes += list(sup.values())
    for i0 in range(0, d, list_chunk):
        lists = torch.arange(i0, min(d, i0 + list_chunk), device=dev)
        ld, lv, cnt = _prune_list(lists, sorted_v, sorted_d, starts, counts,
                                  lam, n)
        tick("prune")
        out = list_block_arrays(
            ld, lv, cnt, fwd32, cfg,
            rep_pos=None if rep_pos is None else rep_pos[lists], tick=tick)
        for dst, src in zip(planes, out):
            dst[i0:i0 + lists.numel()] = src
    fwd_scale = fwd_zero = None
    if cfg.fwd_quant:
        # compact forward index: u8 values (per-doc affine) + u16 coords
        q, fwd_scale, fwd_zero = quantize_u8(docs.vals.to(torch.float32),
                                             by_reciprocal=True)
        coords = docs.coords.to(torch.int32)
        if d < 65536:
            coords = coords.to(torch.int16).view(torch.uint16)
        fwd = PaddedSparse(coords, q, d)
    else:
        fwd = docs.astype(getattr(torch, cfg.fwd_dtype))
    tick("forward")
    return SeismicIndex(
        fwd=fwd, list_docs=list_docs, list_vals=list_vals, list_len=list_len,
        block_off=block_off, block_len=block_len, sum_coords=sum_coords,
        sum_q=sum_q, sum_scale=sum_scale, sum_zero=sum_zero,
        fwd_scale=fwd_scale, fwd_zero=fwd_zero, config=cfg, **sup)


def live_blocks(index: SeismicIndex) -> torch.Tensor:
    """Per-list live-block counts of a built index (the
    :func:`suggest_fanout` statistic)."""
    return (index.block_len > 0).sum(dim=-1).to(torch.int32)


class DocBlockMap(NamedTuple):
    """CSR doc -> (list, block) membership over a built index:
    ``lists[indptr[d]:indptr[d+1]]`` and ``blocks[...]`` enumerate every
    (inverted list, physical block) pair holding doc ``d`` after static
    pruning, ordered by (list, position), on the index's device. The
    quality plane's loss funnel reads it (``repro_torch.obs.quality``)."""
    indptr: torch.Tensor    # int64 [n_docs + 1]
    lists: torch.Tensor     # int32 [n_memberships]
    blocks: torch.Tensor    # int32 [n_memberships]


def doc_block_map(index: SeismicIndex, *,
                  list_chunk: int = 1024) -> DocBlockMap:
    """Invert ``list_docs`` into per-doc block memberships.

    Physical blocks are contiguous position runs per list (``block_off``
    is the cumsum of ``block_len``), so position ``p``'s block is the
    first block whose end exceeds ``p``: one batched ``searchsorted``
    over ``list_chunk`` lists at a time."""
    docs, lens = index.list_docs, index.list_len
    n_lists, lam = docs.shape
    ends = (index.block_off + index.block_len).to(torch.int64)
    pos = torch.arange(lam, device=docs.device)
    member_lists, member_docs, member_blocks = [], [], []
    for a in range(0, n_lists, list_chunk):
        d = docs[a:a + list_chunk]
        live = (pos < lens[a:a + list_chunk, None]) & (d < index.n_docs)
        blk = torch.searchsorted(ends[a:a + list_chunk].contiguous(),
                                 pos.expand(d.shape[0], lam).contiguous(),
                                 right=True)
        rows, _ = live.nonzero(as_tuple=True)
        member_lists.append((rows + a).to(torch.int32))
        member_docs.append(d[live].long())
        member_blocks.append(blk[live].to(torch.int32))
    member_docs = torch.cat(member_docs)
    order = torch.sort(member_docs, stable=True).indices
    counts = torch.bincount(member_docs, minlength=index.n_docs)
    indptr = torch.zeros(index.n_docs + 1, dtype=torch.int64,
                         device=docs.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return DocBlockMap(indptr, torch.cat(member_lists)[order],
                       torch.cat(member_blocks)[order])


def suggest_fanout(n_blocks_stats, *, max_fanout: int = 8) -> int:
    """Superblock fanout from per-list live-block counts (a tensor or a
    sequence): two-tier routing over a list of ``nb`` live blocks costs
    about ``nb / f`` coarse dots plus ``f`` child dots per kept
    superblock, so the best fanout grows like ``sqrt(nb)``; clipped to
    [2, ``max_fanout``]. 0 (flat routing) when the mean over lists with
    live blocks is at most 2, or no list has one."""
    stats = torch.as_tensor(n_blocks_stats, dtype=torch.float64).reshape(-1)
    live = stats[stats > 0]
    if live.numel() == 0:
        return 0
    mean = float(live.mean())
    if mean <= 2.0:
        return 0
    return int(min(max(round(math.sqrt(mean)), 2), max_fanout))
