"""Streaming index mutation: LSM-style tail segments and tombstones (port
of ``repro.core.mutate``).

A built index becomes the *base segment* of a two-level LSM tree, so a
live corpus absorbs inserts and deletes without a full rebuild:

  * **Tail segment** — ``insert_docs`` appends new doc ids to an
    unblocked tail (``SeismicIndex.tail_ids``) and writes their rows into
    the forward index. The scorer scores tail docs exactly, so a freshly
    inserted doc is searchable on the next query.
  * **Tombstones** — ``delete_docs`` sets per-doc bits
    (``SeismicIndex.tombstone``); every retrieval stage masks them to the
    sentinel before merge, so deleted docs are never returned.
  * **Compaction** — ``compact`` folds the tail into the blocked index:
    deleted ids are purged from the lists, and each list the tail touches
    either *appends* delta blocks (minor compaction, summaries through
    :func:`repro_torch.core.build.block_summaries`, superblock summaries
    merged monotonically by
    :func:`repro_torch.core.build.merge_superblock_summary`) or is
    *rebuilt* from its merged member set through
    :func:`repro_torch.core.build.list_block_arrays` with the fresh
    build's representatives (major compaction). ``knn_ids`` is patched
    lazily: deleted ids become sentinels, former-tail docs get out-edges
    by querying the compacted index.

    frozen blocks  +  exact tail  +  tombstones  ==  one logical corpus

The JAX package copies every plane to the host and loops over lists in
Python; here the planes stay on the index's device. Compaction groups
the delta postings with one sort by (coordinate, value desc, doc asc),
summarizes all minor lists' new blocks in batches, rebuilds the major
lists 64 at a time, and writes the results into copies of the planes.
The arrays equal the JAX per-list loop's (the seams round as the JAX
package's eager calls do; ``tests/test_torch_mutate.py``).

Published snapshots are immutable: every plane a mutation changes is
copied first (copy on write), so an index handed to a server never
changes under it. ``epoch`` increments on every visible mutation.
Single-writer: mutate one ``MutableSeismicIndex`` from one thread.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core.build import (block_summaries, build_index,
                                    list_block_arrays,
                                    merge_superblock_summary, sample_rep_pos)
from repro_torch.core.types import SeismicConfig, SeismicIndex
from repro_torch.device import resolve_device
from repro_torch.obs.registry import weak_fn
from repro_torch.sparse.ops import PaddedSparse, widen_coords
from repro_torch.sparse.quant import dequantize_u8, quantize_u8


# lists a major compaction rebuilds together: the builder's default chunk
# (peak memory about 64 * dim * beta floats); minor lists go four chunks
# at a time (their summaries cost nb * S entries a list)
_LIST_CHUNK = 64


def make_mutable(index: SeismicIndex, **kwargs) -> "MutableSeismicIndex":
    """Wrap a built (or loaded) index for streaming mutation; keyword
    arguments go to :class:`MutableSeismicIndex` (``capacity`` reserves
    insert headroom beyond the built corpus)."""
    return MutableSeismicIndex(index, **kwargs)


def _raw(t: torch.Tensor) -> torch.Tensor:
    """A plane as a tensor CUDA can index and copy: a uint16 plane
    through its int16 view (same bits)."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _pad_rows(t: torch.Tensor, grow: int, value=0) -> torch.Tensor:
    raw = _raw(t)
    pad = torch.full((grow,) + tuple(raw.shape[1:]), value, dtype=raw.dtype,
                     device=raw.device)
    return torch.cat([raw, pad]).view(t.dtype)


def _as_plane(rows: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Integer coordinates [n, nnz] in a coordinate plane's dtype, as raw
    bits for a uint16 plane (the builder's conversion)."""
    if dtype == torch.uint16:
        return rows.to(torch.int32).to(torch.int16)
    return rows.to(dtype)


class MutableSeismicIndex:
    """Single-writer mutation wrapper around immutable index snapshots.

    ``.index`` is always a complete, internally consistent
    :class:`SeismicIndex` to hand to the pipeline or a server. Parameters
    and errors are the JAX package's:

    capacity:
        Total doc-id space (existing + insert headroom); defaults to the
        built corpus. Ids are assigned monotonically and never reused.
    tail_cap:
        Tail-segment slots (the ``tail_ids`` length).
    tail_max:
        Occupancy that triggers auto-compaction on the next insert that
        needs room (<= tail_cap; default tail_cap).
    n_docs:
        Ids already assigned (default: every row of the built index).
    registry:
        Optional :class:`repro_torch.obs.MetricsRegistry` receiving the
        ``seismic_index_epoch``, ``seismic_tail_occupancy`` and
        ``seismic_tail_fill_ratio`` gauges, insert, delete and
        compaction counters and the ``seismic_compaction_seconds``
        histogram.
    """

    def __init__(self, index: SeismicIndex, *, capacity: int | None = None,
                 tail_cap: int = 64, tail_max: int | None = None,
                 n_docs: int | None = None, registry=None):
        cfg = index.config
        n_old = index.n_docs
        cap = n_old if capacity is None else int(capacity)
        if cap < n_old:
            raise ValueError(f"capacity {cap} < built corpus {n_old}")
        tail_cap = int(tail_cap)
        if tail_cap <= 0:
            raise ValueError("tail_cap must be positive")
        self.tail_max = tail_cap if tail_max is None else int(tail_max)
        if not (1 <= self.tail_max <= tail_cap):
            raise ValueError(
                f"tail_max {self.tail_max} not in [1, {tail_cap}]")
        self.capacity = cap
        self.tail_cap = tail_cap
        self.config: SeismicConfig = cfg
        self._next_id = n_old if n_docs is None else int(n_docs)
        if not (0 <= self._next_id <= cap):
            raise ValueError(f"n_docs {self._next_id} not in [0, {cap}]")
        self._epoch = 0
        dev = index.device

        # ---- lift the snapshot to capacity: all-zero forward rows, and the
        # old pad sentinel (n_old) remapped to the new one (cap) wherever
        # doc ids appear. Planes that do not change are shared.
        fwd, list_docs, knn = index.fwd, index.list_docs, index.knn_ids
        fwd_scale, fwd_zero = index.fwd_scale, index.fwd_zero
        if cap > n_old:
            grow = cap - n_old
            fwd = PaddedSparse(_pad_rows(fwd.coords, grow),
                               _pad_rows(fwd.vals, grow), index.dim)
            list_docs = torch.where(list_docs == n_old, cap, list_docs)
            if knn is not None:
                knn = _pad_rows(torch.where(knn == n_old, cap, knn), grow,
                                cap)
            if fwd_scale is not None:
                fwd_scale = _pad_rows(fwd_scale, grow)
                fwd_zero = _pad_rows(fwd_zero, grow)

        # tail: resume a persisted one, else start empty; `cap` marks an
        # empty slot
        tail = torch.full((tail_cap,), cap, dtype=torch.int32, device=dev)
        if index.tail_ids is not None:
            old_tail = index.tail_ids
            live = old_tail[old_tail < n_old]
            if live.numel() > tail_cap:
                raise ValueError(
                    f"persisted tail ({live.numel()}) exceeds tail_cap "
                    f"{tail_cap}")
            tail[:live.numel()] = live
        self._tail_occ = int((tail < cap).sum())

        tomb = torch.zeros(cap, dtype=torch.bool, device=dev)
        if index.tombstone is not None:
            tomb[:index.tombstone.numel()] = index.tombstone
        # conservative resume: anything tombstoned may still sit in the
        # lists of a loaded snapshot, so it is purged at the next
        # compaction (the purge is idempotent)
        self._pending = tomb.clone()

        self._index = dataclasses.replace(
            index, fwd=fwd, list_docs=list_docs.to(torch.int32),
            fwd_scale=fwd_scale, fwd_zero=fwd_zero,
            knn_ids=None if knn is None else knn.to(torch.int32),
            tail_ids=tail, tombstone=tomb)
        self._register_metrics(registry)

    # ------------------------------------------------------ lifecycle

    @classmethod
    def empty(cls, dim: int, doc_nnz: int,
              cfg: SeismicConfig = SeismicConfig(), *, capacity: int,
              tail_cap: int = 64, tail_max: int | None = None,
              registry=None, device=None) -> "MutableSeismicIndex":
        """An index with no live docs and room for ``capacity`` of them
        (the grow-from-empty entry point), built over an all-zero
        collection on ``device`` (CUDA unless given), so every plane has
        its final shape up front."""
        dev = resolve_device(device)
        docs = PaddedSparse(
            torch.zeros((capacity, doc_nnz), dtype=torch.int32, device=dev),
            torch.zeros((capacity, doc_nnz), dtype=torch.float32,
                        device=dev), dim)
        return cls(build_index(docs, cfg), capacity=capacity,
                   tail_cap=tail_cap, tail_max=tail_max, n_docs=0,
                   registry=registry)

    @property
    def index(self) -> SeismicIndex:
        """The current published snapshot (hand this to servers)."""
        return self._index

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def n_docs(self) -> int:
        """Ids assigned so far (monotone; includes deleted)."""
        return self._next_id

    @property
    def n_live(self) -> int:
        return self._next_id - int(self._index.tombstone.sum())

    @property
    def tail_occupancy(self) -> int:
        return self._tail_occ

    # ------------------------------------------------------ mutations

    def insert_docs(self, coords, vals) -> torch.Tensor:
        """Insert a batch of docs; returns their assigned ids (int64, on
        the index's device).

        ``coords``/``vals`` are ``[B, nnz]`` (or 1-D for one doc), tensors
        or arrays, with ``vals <= 0`` marking padding and ``nnz <=
        fwd.nnz_max``. Auto-compacts whenever the tail lacks room for the
        next chunk."""
        dev = self._index.device
        coords = torch.as_tensor(coords, device=dev)
        vals = torch.as_tensor(vals, device=dev).to(torch.float32)
        coords, vals = torch.atleast_2d(coords), torch.atleast_2d(vals)
        if coords.shape != vals.shape:
            raise ValueError(f"coords {tuple(coords.shape)} != vals "
                             f"{tuple(vals.shape)}")
        b, nnz = coords.shape
        nnz_max = self._index.fwd.nnz_max
        if nnz > nnz_max:
            raise ValueError(f"doc nnz {nnz} > index nnz_max {nnz_max}")
        if self._next_id + b > self.capacity:
            raise ValueError(
                f"capacity exhausted: {self._next_id} assigned + {b} new "
                f"> {self.capacity}; rebuild with more headroom")
        first = self._next_id
        s = 0
        while s < b:
            room = self.tail_max - self._tail_occ
            if room <= 0:
                self.compact()
                continue
            take = min(room, b - s)
            self._append_tail(coords[s:s + take], vals[s:s + take])
            s += take
        if self._m_inserted is not None:
            self._m_inserted.inc(b)
        return torch.arange(first, self._next_id, dtype=torch.int64,
                            device=dev)

    def _append_tail(self, coords: torch.Tensor, vals: torch.Tensor) -> None:
        idx = self._index
        take, nnz = coords.shape
        dev = idx.device
        # canonical padded rows: non-positive values are padding
        # (coordinate 0, value 0: the all-zero-row convention of the
        # equivalence corpus)
        c = torch.zeros((take, idx.fwd.nnz_max), dtype=torch.int64,
                        device=dev)
        v = torch.zeros((take, idx.fwd.nnz_max), dtype=torch.float32,
                        device=dev)
        c[:, :nnz] = coords
        v[:, :nnz] = vals
        c = torch.where(v > 0, c, 0)
        v = torch.where(v > 0, v, 0.0)
        if bool(((c < 0) | (c >= idx.dim)).any()):
            raise ValueError("doc coords out of range")
        a, b = self._next_id, self._next_id + take

        def put(plane, rows):                    # copy on write
            out = _raw(plane).clone()
            out[a:b] = rows
            return out.view(plane.dtype)

        coords_p = put(idx.fwd.coords, _as_plane(c, idx.fwd.coords.dtype))
        fwd_scale = fwd_zero = None
        if idx.fwd_scale is not None:
            # the compact plane's per-doc affine u8, the JAX seam's
            # rounding (eager: a division by 254)
            q, scale, zero = quantize_u8(v)
            fwd = PaddedSparse(coords_p, put(idx.fwd.vals, q), idx.dim)
            fwd_scale = put(idx.fwd_scale, scale)
            fwd_zero = put(idx.fwd_zero, zero)
        else:
            fwd = PaddedSparse(coords_p, put(idx.fwd.vals,
                                             v.to(idx.fwd.vals.dtype)),
                               idx.dim)
        tail = idx.tail_ids.clone()
        tail[self._tail_occ:self._tail_occ + take] = torch.arange(
            a, b, dtype=torch.int32, device=dev)
        self._index = dataclasses.replace(
            idx, fwd=fwd, fwd_scale=fwd_scale, fwd_zero=fwd_zero,
            tail_ids=tail)
        self._next_id = b
        self._tail_occ += take
        self._epoch += 1

    def delete_docs(self, ids) -> None:
        """Tombstone docs (idempotent): masked from results at once,
        purged from the lists at the next compaction."""
        dev = self._index.device
        ids = torch.unique(torch.as_tensor(ids, device=dev)
                           .to(torch.int64).reshape(-1))
        if ids.numel() == 0:
            return
        lo, hi = int(ids[0]), int(ids[-1])
        if lo < 0 or hi >= self._next_id:
            raise ValueError(
                f"delete ids must be in [0, {self._next_id}), got "
                f"[{lo}, {hi}]")
        idx = self._index
        tomb = idx.tombstone.clone()
        tomb[ids] = True
        self._index = dataclasses.replace(idx, tombstone=tomb)
        self._pending[ids] = True
        self._epoch += 1
        if self._m_deleted is not None:
            self._m_deleted.inc(int(ids.numel()))

    # ----------------------------------------------------- compaction

    def compact(self) -> None:
        """Fold the tail into the blocked index and purge tombstones.

        Per list the tail touches: *minor* (append) compaction when the
        delta fits the list's spare positions and block slots — new
        blocks of ``block_cap`` in value-descending order, summaries
        through the builder's own path, superblock summaries merged
        monotonically; otherwise a *major* rebuild of the list from its
        merged member set through :func:`list_block_arrays`, with the
        representatives a fresh build draws for it. No-op when the tail
        and the pending deletes are both empty."""
        t0 = time.monotonic()
        idx = self._index
        cfg = idx.config
        cap = self.capacity
        dev = idx.device
        tail = idx.tail_ids
        tomb = idx.tombstone
        live_tail = tail[tail < cap].long()
        live_tail = live_tail[~tomb[live_tail]]
        pending = self._pending.nonzero().flatten()
        if live_tail.numel() == 0 and pending.numel() == 0:
            return

        # copies of every plane compaction may change (copy on write)
        list_docs = idx.list_docs.clone()
        list_vals = idx.list_vals.clone()
        list_len = idx.list_len.clone()
        block_off = idx.block_off.clone()
        block_len = idx.block_len.clone()
        summ = [idx.sum_coords.clone(), idx.sum_q.clone(),
                idx.sum_scale.clone(), idx.sum_zero.clone()]
        has_sup = idx.sup_coords is not None
        sup = ([idx.sup_coords.clone(), idx.sup_q.clone(),
                idx.sup_scale.clone(), idx.sup_zero.clone()]
               if has_sup else [])
        fwd_c = _raw(idx.fwd.coords).clone()
        fwd_v = idx.fwd.vals.clone()
        quant = idx.fwd_scale is not None
        fwd_scale = idx.fwd_scale.clone() if quant else None
        fwd_zero = idx.fwd_zero.clone() if quant else None

        # ---- 1. purge tombstones. List positions keep their block
        # (summaries become loose but valid upper bounds); forward rows go
        # all-zero, so the logical corpus equals the live docs.
        dead_id = torch.cat([self._pending,
                             torch.zeros(1, dtype=torch.bool, device=dev)])
        if pending.numel():
            dead = dead_id.index_select(0, list_docs.reshape(-1)) \
                .view_as(list_docs)
            list_docs.masked_fill_(dead, cap)
            list_vals.masked_fill_(dead, 0.0)
            fwd_c[pending] = 0
            fwd_v[pending] = 0
            if quant:
                fwd_scale[pending] = 0.0
                fwd_zero[pending] = 0.0
        fwd_c = fwd_c.view(idx.fwd.coords.dtype)

        # float32 forward view for the builder seams (the fresh build's
        # `docs.astype(float32)` for an unquantized plane)
        if quant:
            v32 = dequantize_u8(fwd_v, fwd_scale, fwd_zero)
            c32 = widen_coords(fwd_c).to(torch.int32)
        else:
            v32 = fwd_v.to(torch.float32)
            c32 = fwd_c
        fwd32 = PaddedSparse(c32, v32, idx.dim)

        # ---- 2. delta membership of the live tail docs, grouped by list
        # in the builder's posting order: value desc, then doc asc
        tdocs = torch.sort(live_tail).values
        ec = widen_coords(c32[tdocs])                      # [T, nnz]
        ev = v32[tdocs]
        ed = tdocs[:, None].expand_as(ec)
        pos = ev > 0
        ec, ev, ed = ec[pos], ev[pos], ed[pos]             # doc-ascending
        key = (ec << 32) | (0x7FFFFFFF - ev.view(torch.int32).to(torch.int64))
        order = torch.sort(key, stable=True).indices
        ec, ev, ed = ec[order], ev[order], ed[order].to(torch.int32)
        lists, dcount = torch.unique_consecutive(ec, return_counts=True)
        dstart = torch.cumsum(dcount, 0) - dcount

        lam, nb, bcap = cfg.lam, cfg.n_blocks, cfg.block_cap
        base_len = list_len[lists].to(torch.int64)
        nb_used = (block_len[lists] > 0).sum(1)            # blocks are a
        n_new = (dcount + bcap - 1) // bcap                # slot prefix
        minor = (base_len + dcount <= lam) & (nb_used + n_new <= nb)
        planes = dict(list_docs=list_docs, list_vals=list_vals,
                      block_off=block_off, block_len=block_len, summ=summ,
                      sup=sup, cap=cap, fwd32=fwd32)
        ml = minor.nonzero().flatten()
        jl = (~minor).nonzero().flatten()
        if ml.numel():
            self._minor(planes, lists[ml], dcount[ml], dstart[ml],
                        base_len[ml], nb_used[ml], n_new[ml], ed, ev)
            list_len[lists[ml]] += dcount[ml].to(list_len.dtype)
        for j0 in range(0, jl.numel(), _LIST_CHUNK):
            j = jl[j0:j0 + _LIST_CHUNK]
            cnt = self._major(planes, lists[j], dcount[j], dstart[j],
                              base_len[j], ed, ev)
            list_len[lists[j]] = cnt
        n_minor, n_major = ml.numel(), jl.numel()

        # ---- 3. publish the compacted snapshot (tail now empty)
        compacted = dataclasses.replace(
            idx, fwd=PaddedSparse(fwd_c, fwd_v, idx.dim),
            list_docs=list_docs, list_vals=list_vals, list_len=list_len,
            block_off=block_off, block_len=block_len,
            sum_coords=summ[0], sum_q=summ[1], sum_scale=summ[2],
            sum_zero=summ[3], fwd_scale=fwd_scale, fwd_zero=fwd_zero,
            sup_coords=sup[0] if has_sup else None,
            sup_q=sup[1] if has_sup else None,
            sup_scale=sup[2] if has_sup else None,
            sup_zero=sup[3] if has_sup else None,
            tail_ids=torch.full((self.tail_cap,), cap, dtype=torch.int32,
                                device=dev))

        # ---- 4. lazy graph patch: dead edges -> sentinel, former-tail
        # docs get fresh out-edges by querying the compacted index
        if idx.knn_ids is not None:
            knn = idx.knn_ids.clone()
            if pending.numel():
                knn.masked_fill_(dead_id.index_select(0, knn.reshape(-1))
                                 .view_as(knn), cap)
                knn[pending] = cap
            if live_tail.numel():
                knn[live_tail] = self._fresh_edges(
                    compacted, live_tail, c32, v32, tomb, knn.shape[1])
            compacted = dataclasses.replace(compacted, knn_ids=knn)

        self._index = compacted
        self._tail_occ = 0
        self._pending.zero_()
        self._epoch += 1
        dt = time.monotonic() - t0
        if self._m_compactions is not None:
            self._m_compactions.inc()
            self._m_compact_s.record(dt)
            self._m_compact_minor.inc(n_minor)
            self._m_compact_major.inc(n_major)

    def _minor(self, planes, ls, d, start, base_len, nb_used, n_new, ed,
               ev) -> None:
        """Append each list's delta members ([start, start + d) of the
        grouped postings) after its ``base_len`` live positions, as new
        blocks in slots ``nb_used ..``; merge the superblocks they join."""
        cfg = self.config
        nb, bcap, cap = cfg.n_blocks, cfg.block_cap, planes["cap"]
        dev = ls.device
        ell = ls.long()
        # members: list j's i-th delta posting goes to position base + i
        j = torch.repeat_interleave(torch.arange(ls.numel(), device=dev), d)
        i = torch.arange(j.numel(), device=dev) - (torch.cumsum(d, 0) - d)[j]
        e = start[j] + i
        planes["list_docs"][ell[j], base_len[j] + i] = ed[e]
        planes["list_vals"][ell[j], base_len[j] + i] = ev[e]
        # summaries of the new blocks only, through the builder's seam: an
        # artificial layout, delta docs in a prefix, block k = i // bcap
        for c0 in range(0, ls.numel(), 4 * _LIST_CHUNK):
            c = slice(c0, c0 + 4 * _LIST_CHUNK)
            w = int(d[c].max())
            pos = torch.arange(w, device=dev)
            valid = pos < d[c, None]
            src = (start[c, None] + pos).clamp(max=max(ed.numel() - 1, 0))
            docs_perm = torch.where(valid, ed[src], cap)
            block_id = torch.where(valid, pos // bcap, nb).to(torch.int32)
            out = block_summaries(docs_perm, block_id, planes["fwd32"], cfg)
            bj, bk = (torch.arange(nb, device=dev) < n_new[c, None]) \
                .nonzero(as_tuple=True)
            row, slot = ell[c][bj], nb_used[c][bj] + bk
            planes["block_off"][row, slot] = (base_len[c][bj]
                                              + bk * bcap).to(torch.int32)
            planes["block_len"][row, slot] = torch.clamp(
                d[c][bj] - bk * bcap, max=bcap).to(torch.int32)
            for dst, src_ in zip(planes["summ"], out):
                dst[row, slot] = src_[bj, bk]
        if not planes["sup"]:
            return
        # superblocks the new slots join: (list, group) pairs, each merged
        # with its new children (the others enter as level-0 rows)
        f = cfg.superblock_fanout
        g0 = nb_used // f
        ng = (nb_used + n_new - 1) // f - g0 + 1
        pj, pk = (torch.arange(cfg.n_superblocks, device=dev)
                  < ng[:, None]).nonzero(as_tuple=True)
        g = g0[pj] + pk
        slots = g[:, None] * f + torch.arange(f, device=dev)      # [P, f]
        new = ((slots >= nb_used[pj, None])
               & (slots < (nb_used + n_new)[pj, None]) & (slots < nb))
        row = ell[pj][:, None]
        cs = slots.clamp(max=nb - 1)
        sc, q, scale, zero = (p[row, cs] for p in planes["summ"])
        q = torch.where(new[..., None], q, 0)
        sup = planes["sup"]
        merged = merge_superblock_summary(
            sup[0][ell[pj], g], sup[1][ell[pj], g], sup[2][ell[pj], g],
            sup[3][ell[pj], g], sc, q, scale, zero, planes["fwd32"].dim, cfg)
        for dst, src_ in zip(sup, merged):
            dst[ell[pj], g] = src_

    def _major(self, planes, ls, d, start, base_len, ed, ev) -> torch.Tensor:
        """Rebuild lists from their merged member sets (live base members
        and delta), sorted by value desc then doc asc and pruned to lam,
        through the fresh build's per-list path; returns their lengths."""
        cfg = self.config
        lam, cap = cfg.lam, planes["cap"]
        dev = ls.device
        ell = ls.long()
        base_docs = planes["list_docs"][ell]
        base_vals = planes["list_vals"][ell]
        pos = torch.arange(lam, device=dev)
        keep = (pos < base_len[:, None]) & (base_docs < cap)
        w = int(d.max())
        di = torch.arange(w, device=dev)
        valid = di < d[:, None]
        src = (start[:, None] + di).clamp(max=max(ed.numel() - 1, 0))
        mdocs = torch.cat([torch.where(keep, base_docs, cap),
                           torch.where(valid, ed[src], cap)], dim=1)
        mvals = torch.cat([torch.where(keep, base_vals, -1.0),
                           torch.where(valid, ev[src], -1.0)], dim=1)
        o = torch.sort(mdocs, dim=1, stable=True).indices
        mdocs, mvals = mdocs.gather(1, o), mvals.gather(1, o)
        o = torch.sort(-mvals, dim=1, stable=True).indices[:, :lam]
        mdocs, mvals = mdocs.gather(1, o), mvals.gather(1, o)
        cnt = (keep.sum(1) + d).clamp(max=lam)
        live = pos < cnt[:, None]
        docs_p = torch.where(live, mdocs, cap).to(torch.int32)
        vals_p = torch.where(live, mvals, 0.0)
        cnt = cnt.to(torch.int32)
        rep_pos = (None if cfg.blocking == "fixed"
                   else sample_rep_pos(cnt, cfg, ls))
        out = list_block_arrays(docs_p, vals_p, cnt, planes["fwd32"], cfg,
                                rep_pos=rep_pos, fused=False)
        dst = [planes["list_docs"], planes["list_vals"], None,
               planes["block_off"], planes["block_len"], *planes["summ"],
               *planes["sup"]]
        for plane, rows in zip(dst, out):
            if plane is not None:
                plane[ell] = rows
        return cnt

    def _fresh_edges(self, compacted: SeismicIndex, new_ids: torch.Tensor,
                     c32: torch.Tensor, v32: torch.Tensor,
                     tomb: torch.Tensor, degree: int) -> torch.Tensor:
        """Out-edges int32 [T, degree] for compacted-in docs: their forward
        rows go through the pipeline as queries (the graph builder's
        recipe), self, tombstoned and padding hits dropped, sentinel
        padded."""
        from repro_torch.retrieval.params import SearchParams
        from repro_torch.retrieval.pipeline import search_pipeline

        cfg = compacted.config
        # the port's defaults (use_kernel=True, fuse_level=1) differ from
        # the JAX package's; every level gives equal ids, so the edges are
        p = SearchParams(k=degree + 1, cut=8,
                         block_budget=min(64, 8 * cfg.n_blocks),
                         policy="budget")
        q = PaddedSparse(c32[new_ids].to(torch.int32), v32[new_ids],
                         compacted.dim)
        _, ids, _ = search_pipeline(compacted, q, p)
        keep = ((ids >= 0) & (ids != new_ids[:, None])
                & ~tomb[ids.long().clamp(min=0)])
        # a stable sort on "not kept" moves kept entries to the front
        order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
        picked = ids.gather(1, order)[:, :degree]
        kept = keep.gather(1, order)[:, :degree]
        return torch.where(kept, picked, self.capacity).to(torch.int32)

    # -------------------------------------------------------- metrics

    def _register_metrics(self, registry) -> None:
        self._m_inserted = self._m_deleted = None
        self._m_compactions = self._m_compact_s = None
        self._m_compact_minor = self._m_compact_major = None
        if registry is None:
            return
        registry.gauge(
            "seismic_index_epoch",
            "Mutation epoch of the index (bumped on every visible "
            "mutation)").labels().set_fn(weak_fn(self, lambda s: s._epoch))
        registry.gauge(
            "seismic_tail_occupancy",
            "Live docs in the unblocked tail segment").labels().set_fn(
            weak_fn(self, lambda s: s._tail_occ))
        registry.gauge(
            "seismic_tail_fill_ratio",
            "Tail occupancy / tail_max (1.0 = next insert "
            "compacts)").labels().set_fn(
            weak_fn(self, lambda s: s._tail_occ / s.tail_max))
        self._m_inserted = registry.counter(
            "seismic_docs_inserted_total", "Docs inserted").labels()
        self._m_deleted = registry.counter(
            "seismic_docs_deleted_total", "Docs tombstoned").labels()
        self._m_compactions = registry.counter(
            "seismic_compactions_total", "Compaction runs").labels()
        self._m_compact_minor = registry.counter(
            "seismic_compaction_lists_minor_total",
            "Lists compacted by block append").labels()
        self._m_compact_major = registry.counter(
            "seismic_compaction_lists_major_total",
            "Lists compacted by full per-list rebuild").labels()
        self._m_compact_s = registry.histogram(
            "seismic_compaction_seconds", "Wall time per compaction",
            lo=1e-5, hi=1e3).labels()
