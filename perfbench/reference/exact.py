"""The plain reference: exact inner products and exact top-k, worked out
from the collection alone.

Nothing here imports the program. ``answer_check`` holds every returned
(query, id, score) to the float64 inner product of the query with the
document as the configuration stores it (``value_dtype``: the forward
index's values, bfloat16 in the MS MARCO configurations), and each row to
the shape of a top-k answer. ``exact_topk`` scores the whole collection
for a block of queries, ``doc_chunk`` documents at a time, as one sparse
(CSR) by dense product in float32, and keeps a running top-k. ``check``
holds a run's answers to both and gives the numbers the configuration's
``limits`` name.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch


def dense_queries(q_coords: torch.Tensor, q_vals: torch.Tensor, dim: int,
                  dtype=torch.float64) -> torch.Tensor:
    """[Q, nnz] padded-sparse queries -> [Q, dim] dense."""
    out = torch.zeros((q_coords.shape[0], dim), dtype=dtype,
                      device=q_coords.device)
    rows = torch.arange(q_coords.shape[0], device=q_coords.device)
    out.index_put_((rows[:, None].expand(q_coords.shape), q_coords.long()),
                   q_vals.to(dtype), accumulate=True)
    return out


@dataclasses.dataclass
class RowCheck:
    """One batch of answers held to the reference: per row, whether it is
    malformed, and its largest relative score gap (0 for a row without a
    valid id)."""

    bad: torch.Tensor       # bool [Q]
    gap: torch.Tensor       # f64 [Q]


def answer_check(q_dense: torch.Tensor, doc_coords: torch.Tensor,
                 doc_vals: torch.Tensor, ids: torch.Tensor,
                 scores: torch.Tensor, evaluated: torch.Tensor,
                 value_dtype: torch.dtype) -> RowCheck:
    """Hold answers ``ids`` / ``scores`` [Q, k] (ids -1 past the answered
    ones) to the reference.

    A row is malformed when an id lies outside the collection (other than
    -1 padding), when -1 padding comes before a valid id, when it has
    fewer valid ids than ``min(k, evaluated)``, when a valid id repeats,
    or when its valid scores are not finite and non-increasing. The gap
    of a valid entry is ``|score - ip| / |ip|``, ``ip`` the float64 inner
    product of the query (``q_dense`` [Q, dim], float64) with the
    document's values rounded to ``value_dtype``."""
    n_docs = doc_coords.shape[0]
    qn, k = ids.shape
    ids = ids.long()
    valid = (ids >= 0) & (ids < n_docs)
    padding = ids == -1
    bad = ~(valid | padding).all(dim=1)
    # padding only after the valid ids, and as many valid ids as expected
    n_valid = valid.sum(dim=1)
    bad |= (valid.cumsum(dim=1) != torch.arange(1, k + 1, device=ids.device)
            .clamp(max=n_valid[:, None])).any(dim=1)
    bad |= n_valid != torch.clamp(evaluated.long(), max=k)
    # distinct ids
    srt = torch.sort(torch.where(valid, ids, -1 - torch.arange(
        k, device=ids.device)), dim=1).values
    bad |= (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    # finite, non-increasing scores over the valid prefix
    s = scores.to(torch.float64)
    bad |= (valid & ~torch.isfinite(s)).any(dim=1)
    pair = valid[:, 1:] & valid[:, :-1]
    bad |= (pair & (s[:, 1:] > s[:, :-1])).any(dim=1)
    # scores against the float64 inner products
    safe = torch.where(valid, ids, 0)
    dc = doc_coords[safe].long()                       # [Q, k, nnz]
    dv = doc_vals[safe].to(value_dtype).to(torch.float64)
    ip = (q_dense.gather(1, dc.reshape(qn, -1)).reshape(dc.shape)
          * dv).sum(dim=-1)                            # [Q, k]
    gap = (s - ip).abs() / ip.abs().clamp_min(torch.finfo(torch.float64).tiny)
    gap = torch.where(valid & torch.isfinite(s), gap, 0.0)
    return RowCheck(bad=bad, gap=gap.amax(dim=1))


def exact_topk(doc_coords: torch.Tensor, doc_vals: torch.Tensor, dim: int,
               q_coords: torch.Tensor, q_vals: torch.Tensor, k: int, *,
               doc_chunk: int = 1 << 19) -> torch.Tensor:
    """Ids int64 [Q, k] of the ``k`` highest inner products of each query
    over the whole collection, in float32 over the collection's own
    values, on the collection's device."""
    dev = doc_coords.device
    n, nnz = doc_coords.shape
    qt = dense_queries(q_coords.to(dev), q_vals.to(dev), dim,
                       torch.float32).T.contiguous()          # [dim, Q]
    qn = qt.shape[1]
    best_s = torch.empty((0, qn), dtype=torch.float32, device=dev)
    best_i = torch.empty((0, qn), dtype=torch.int64, device=dev)
    for a in range(0, n, doc_chunk):
        b = min(n, a + doc_chunk)
        c, order = torch.sort(doc_coords[a:b].long(), dim=1)
        v = doc_vals[a:b].to(torch.float32).gather(1, order)
        crow = torch.arange(0, (b - a) + 1, device=dev,
                            dtype=torch.int64) * nnz
        with warnings.catch_warnings():     # "CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            mat = torch.sparse_csr_tensor(crow, c.reshape(-1), v.reshape(-1),
                                          size=(b - a, dim),
                                          check_invariants=False)
        sc = mat @ qt                                          # [b - a, Q]
        top_s, top_i = torch.topk(sc, min(k, b - a), dim=0)
        cat_s = torch.cat([best_s, top_s])
        cat_i = torch.cat([best_i, top_i + a])
        keep_s, pos = torch.topk(cat_s, min(k, cat_s.shape[0]), dim=0)
        best_s, best_i = keep_s, cat_i.gather(0, pos)
        del mat, sc, c, v, order
    return best_i.T.contiguous()


def recall_at_k(answer_ids: torch.Tensor, exact_ids: torch.Tensor) -> float:
    """Mean over queries of |answer ∩ exact| / k (ids [Q, k])."""
    a = answer_ids.long()
    hit = (a[:, :, None] == exact_ids.long()[:, None, :]) & (a[:, :, None]
                                                             >= 0)
    return float(hit.any(dim=1).sum(dim=1).double().mean()
                 / exact_ids.shape[1])


def check(config: dict, traffic: dict, coll, batches: list, answers: list,
          seed: int) -> tuple[dict, int]:
    """Hold a run's answers [(batch, (scores, ids, evaluated))] to the
    reference -> ({name: value}, queries failed).

    ``bad_rows`` counts malformed rows and ``score_gap`` is the largest
    relative score gap over every answer (``answer_check``).
    ``recall_at_k`` is the recall@k of the first answer to each of
    ``traffic["recall_sample"]`` pool queries drawn from the seed (those
    whose batch was answered) against ``exact_topk`` over the whole
    collection. A query fails when its row is malformed or its gap
    exceeds the configuration's ``score_gap`` limit."""
    value_dtype = getattr(torch, config["index"]["fwd_dtype"])
    gap_limit = config["limits"]["score_gap"]["max"]
    dev = coll.doc_coords.device
    bad_rows, worst_gap, failed = 0, 0.0, 0
    for b in range(len(batches)):
        mine = [a for bb, a in answers if bb == b]
        if not mine:
            continue
        qc, qv = (t.to(dev) for t in batches[b])
        q_dense = dense_queries(qc, qv, coll.dim)
        for s, ids, ev in mine:
            rc = answer_check(q_dense, coll.doc_coords, coll.doc_vals,
                              ids.to(dev), s.to(dev), ev.to(dev), value_dtype)
            bad_rows += int(rc.bad.sum())
            worst_gap = max(worst_gap, float(rc.gap.max()))
            failed += int((rc.bad | (rc.gap > gap_limit)).sum())
        del q_dense
    values = {"bad_rows": bad_rows, "score_gap": worst_gap,
              "recall_at_k": sample_recall(traffic, coll, answers, seed)}
    return values, failed


def sample_recall(traffic: dict, coll, answers: list,
                  seed: int) -> float | None:
    """Recall@k against the exact top-k of ``traffic["recall_sample"]``
    pool queries drawn from the seed (those the run answered), each
    answered by the first answer to its batch."""
    batch, pool = traffic["batch"], coll.q_coords.shape[0]
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))
    sample = torch.randperm(pool, generator=g)[:traffic["recall_sample"]]
    first: dict = {}
    for b, (_, ids, _) in answers:
        first.setdefault(b, ids)
    sample = torch.sort(sample[torch.tensor(
        [int(q) // batch in first for q in sample], dtype=torch.bool)]).values
    if sample.numel() == 0:
        return None
    got = torch.stack([first[int(q) // batch][int(q) % batch]
                       for q in sample])
    dev = coll.doc_coords.device
    ex = exact_topk(coll.doc_coords, coll.doc_vals, coll.dim,
                    coll.q_coords[sample.to(dev)],
                    coll.q_vals[sample.to(dev)], traffic["k"])
    return recall_at_k(got, ex.cpu())
