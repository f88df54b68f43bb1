"""The bytes and operations a kernel must move and do at given inputs:
the numerator of its roofline share.

Frozen copies of the counts ``chip_smoke.py`` phase 8 makes. Each input
byte is counted once and each output byte once, whatever a kernel reads
again:

* ``gather_dot_cand``: the candidate ids and the output scores, one
  forward row (``row_bytes``) for each distinct live candidate document
  of the batch, and q as one float32 for each distinct (query,
  coordinate) among the entries of a query's live candidate rows; 2
  operations (a multiply-add) per entry of a live candidate row.
* ``router_hier``: the probed lists, the ``block_len`` row of each
  distinct probed list, each of their live superblock summaries and each
  distinct scored child summary (5 bytes an entry: coordinate and u8
  level; 8 a row: scale and zero), the outputs (score and position, 8
  bytes per kept child slot), and q at those rows' entries; 4 operations
  per entry of a scored summary row (dequantize and multiply-add).
"""
from __future__ import annotations

import torch

Q_CHUNK = 256          # queries a bitmap of hit coordinates covers at once


def distinct_query_coords(dim: int, reads, qn: int) -> int:
    """Distinct (query, coordinate) pairs among the entries of the rows a
    kernel reads. Each read is a function of a query range [a, b) that
    returns (coords [b - a, rows, width], live [b - a, rows] or None for
    every row)."""
    n_hit = 0
    for a in range(0, qn, Q_CHUNK):
        b = min(qn, a + Q_CHUNK)
        hit = None
        for read in reads:
            coords, live = read(a, b)
            if hit is None:
                hit = torch.zeros((b - a, dim), dtype=torch.bool,
                                  device=coords.device)
            c = coords.long().reshape(b - a, -1, coords.shape[-1])
            if live is None:
                hit.scatter_(1, c.reshape(b - a, -1), True)
            else:
                qi, ri = live.reshape(b - a, -1).nonzero(as_tuple=True)
                hit[qi[:, None], c[qi, ri]] = True
        n_hit += int(hit.sum())
    return n_hit


def gather_dot_cand(cand: torch.Tensor, n_docs: int, doc_coords: torch.Tensor,
                    dim: int, row_bytes: int) -> tuple[int, int]:
    """(bytes, operations) of one launch on candidates ``cand`` int32 [Q,
    C] (ids ascending, the sentinel ``n_docs`` past the live ones), with
    the documents' coordinates ``doc_coords`` [n_docs, nnz]."""
    qn, c = cand.shape
    nnz = doc_coords.shape[1]
    live = cand < n_docs
    ids = cand.long().clamp(0, n_docs - 1)
    n_live = int(live.sum())
    n_rows = torch.unique(cand[live]).numel()

    def read(a, b):
        return doc_coords[ids[a:b]], live[a:b]

    q_bytes = 4 * distinct_query_coords(dim, [read], qn)
    nbytes = n_rows * row_bytes + cand.numel() * 4 + qn * c * 4 + q_bytes
    return nbytes, 2 * n_live * nnz


def router_hier(lists: torch.Tensor, r: torch.Tensor, block_len: torch.Tensor,
                sup_coords: torch.Tensor, sum_coords: torch.Tensor,
                fanout: int, kept: int, dim: int) -> tuple[int, int]:
    """(bytes, operations) of one launch over probed lists ``lists`` [Q,
    cut], whose scored children are the finite entries of ``r`` [Q, cut *
    n_blocks] (the route's scores in the flat layout), over the planes
    ``block_len`` [L, nb], ``sup_coords`` [L, ns, S2] and ``sum_coords``
    [L, nb, S]; ``kept`` superblocks per query of ``fanout`` children."""
    qn = lists.shape[0]
    nb, s = sum_coords.shape[1], sum_coords.shape[2]
    ns, s2 = sup_coords.shape[1], sup_coords.shape[2]
    alive = torch.nn.functional.pad(block_len > 0, (0, ns * fanout - nb))
    sup_alive = alive.reshape(alive.shape[0], ns, fanout).any(-1)   # [L, ns]
    lh = lists.long()
    distinct = torch.unique(lh)
    rows = int(sup_alive[distinct].sum())
    alive_rows = int(sup_alive[lh].sum())
    live = torch.isfinite(r)                                    # [Q, cut*nb]
    pos = torch.arange(r.shape[1], device=r.device)
    child = lh[:, pos // nb] * nb + pos % nb                    # [Q, cut*nb]
    n_child = torch.unique(child[live]).numel()
    flat_sum = sum_coords.reshape(-1, s)

    def sup_read(a, b):
        return sup_coords[lh[a:b]], sup_alive[lh[a:b]]

    def child_read(a, b):
        return flat_sum[child[a:b]], live[a:b]

    q_bytes = 4 * distinct_query_coords(dim, [sup_read, child_read], qn)
    nbytes = (lists.numel() * 4 + distinct.numel() * nb * 4
              + rows * (s2 * 5 + 8) + n_child * (s * 5 + 8)
              + qn * kept * fanout * 8 + q_bytes)
    return nbytes, 4 * (alive_rows * s2 + int(live.sum()) * s)
