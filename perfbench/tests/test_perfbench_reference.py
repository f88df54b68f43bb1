"""The plain reference, the frozen byte counts and the trace reader, each
against a hand count or a dense product at a tiny size."""
from __future__ import annotations

import torch
from tiny_cells import TINY_COLLECTION

from perfbench import devtrace
from perfbench.reference import collection, exact, peaks, workbytes


def _tiny(seed=3, n_queries=24):
    return collection.make_collection({**TINY_COLLECTION, "n_docs": 3000},
                                      n_queries, seed, "cpu",
                                      chunk_rows=1000)


def test_collection_is_a_function_of_the_seed():
    a, b, c = _tiny(5), _tiny(5), _tiny(6)
    assert torch.equal(a.doc_coords, b.doc_coords)
    assert torch.equal(a.q_vals, b.q_vals)
    assert not torch.equal(a.doc_coords, c.doc_coords)
    # distinct coordinates a row, positive values, a row maximum of 3
    srt = torch.sort(a.doc_coords, dim=1).values
    assert (srt[:, 1:] != srt[:, :-1]).all()
    assert (a.doc_vals > 0).all()
    assert torch.allclose(a.doc_vals.amax(dim=1), torch.tensor(3.0))
    big = collection.make_collection({**TINY_COLLECTION, "n_docs": 3},
                                     2, 2**40 + 3, "cpu")
    assert big.doc_coords.shape == (3, TINY_COLLECTION["doc_nnz"])


def test_blocked_exact_topk_equals_a_dense_product():
    col = _tiny()
    docs = exact.dense_queries(col.doc_coords, col.doc_vals, col.dim,
                               torch.float64)
    qs = exact.dense_queries(col.q_coords, col.q_vals, col.dim)
    want = torch.topk(qs @ docs.T, 10, dim=1).indices
    got = exact.exact_topk(col.doc_coords, col.doc_vals, col.dim,
                           col.q_coords, col.q_vals, 10, doc_chunk=700)
    assert torch.equal(got, want)
    assert exact.recall_at_k(got, want) == 1.0
    half = torch.cat([got[:, :5], torch.full_like(got[:, 5:], -1)], dim=1)
    assert exact.recall_at_k(half, want) == 0.5


def test_answer_check_holds_scores_and_rows():
    col = _tiny()
    q = exact.dense_queries(col.q_coords, col.q_vals, col.dim)
    ids = exact.exact_topk(col.doc_coords, col.doc_vals, col.dim,
                           col.q_coords, col.q_vals, 10)
    dv = col.doc_vals.to(torch.bfloat16).double()
    ip = torch.stack([(q[i, col.doc_coords[ids[i]].long()] * dv[ids[i]])
                      .sum(-1) for i in range(ids.shape[0])])
    ip, order = torch.sort(ip, dim=1, descending=True)
    ids = ids.gather(1, order)
    ev = torch.full((ids.shape[0],), 500)
    ok = exact.answer_check(q, col.doc_coords, col.doc_vals, ids,
                            ip.float(), ev, torch.bfloat16)
    assert not ok.bad.any() and float(ok.gap.max()) < 1e-6
    # a float32 value for the stored bf16 one: a gap of bf16's rounding
    f32 = exact.answer_check(q, col.doc_coords, col.doc_vals, ids,
                             ip.float(), ev, torch.float32)
    assert float(f32.gap.max()) > 1e-4
    broken = {
        "out of range": lambda i, s: (i.index_fill(1, torch.tensor([3]),
                                                   10**7), s),
        "repeat": lambda i, s: (torch.cat([i[:, :1], i[:, :-1]], 1),
                                torch.cat([s[:, :1], s[:, :-1]], 1)),
        "rising": lambda i, s: (i.flip(1), s.flip(1)),
        "padding first": lambda i, s: (
            torch.cat([torch.full_like(i[:, :1], -1), i[:, 1:]], 1), s),
        "short": lambda i, s: (
            torch.cat([i[:, :-1], torch.full_like(i[:, :1], -1)], 1),
            torch.cat([s[:, :-1], torch.full_like(s[:, :1], -torch.inf)],
                      1)),
    }
    for name, fault in broken.items():
        i, s = fault(ids, ip.float())
        rc = exact.answer_check(q, col.doc_coords, col.doc_vals, i, s, ev,
                                torch.bfloat16)
        assert rc.bad.all(), name
    # fewer evaluated documents than k: -1 padding after them is sound
    short = torch.cat([ids[:, :4], torch.full_like(ids[:, 4:], -1)], 1)
    rc = exact.answer_check(q, col.doc_coords, col.doc_vals, short,
                            ip.float(), torch.full_like(ev, 4),
                            torch.bfloat16)
    assert not rc.bad.any()


def test_gather_dot_cand_bytes_by_hand():
    # 4 docs of 3 coordinates in dim 8; 2 queries, 3 candidate slots
    coords = torch.tensor([[0, 1, 2], [2, 3, 4], [4, 5, 6], [6, 7, 0]])
    cand = torch.tensor([[0, 1, 4], [1, 2, 4]], dtype=torch.int32)
    nbytes, ops = workbytes.gather_dot_cand(cand, 4, coords, 8, row_bytes=18)
    # distinct live docs {0, 1, 2}: 3 rows; q: query 0 hits {0..4} (5),
    # query 1 hits {2..6} (5); ids and scores 2 x 3 x 4 each
    assert nbytes == 3 * 18 + 24 + 24 + 4 * 10
    assert ops == 2 * 4 * 3


def test_router_hier_bytes_by_hand():
    # 3 lists, 4 blocks of 2-entry summaries, superblocks of fanout 2
    # (2 superblocks of 3 entries); the last block of list 1 is empty
    block_len = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 0], [0, 0, 0, 0]])
    sum_coords = torch.arange(3 * 4 * 2).reshape(3, 4, 2) % 8
    sup_coords = torch.arange(3 * 2 * 3).reshape(3, 2, 3) % 8
    lists = torch.tensor([[0, 1], [1, 2]])
    r = torch.full((2, 2 * 4), -torch.inf)
    r[0, 0] = r[0, 5] = 1.0          # (list 0, block 0), (list 1, block 1)
    r[1, 1] = 1.0                    # (list 1, block 1)
    nbytes, ops = workbytes.router_hier(lists, r, block_len, sup_coords,
                                        sum_coords, fanout=2, kept=1, dim=8)
    # distinct lists {0, 1, 2}; live superblock rows 2 + 2 + 0 = 4; scored
    # children (0, 0) and (1, 1): 2 distinct. q: query 0 reads superblock
    # rows of lists 0 and 1 (coords 0..5 and 6, 7, 0..3: all 8) ->8;
    # query 1 reads list 1's (coords 6, 7, 0..3) and child (1, 1)'s
    # (coords 10 % 8, 11 % 8 = 2, 3) -> 6
    assert nbytes == (4 * 4 + 3 * 4 * 4 + 4 * (3 * 5 + 8) + 2 * (2 * 5 + 8)
                      + 2 * 1 * 2 * 8 + 4 * (8 + 6))
    # entries of live superblock rows the queries probe (2 + 2 + 2 + 0) x 3,
    # scored children 3 x 2
    assert ops == 4 * (6 * 3 + 3 * 2)


def test_roofline_share_takes_the_larger_bound():
    assert peaks.roofline_share(3.35e12, 0, 2.0) == 50.0
    assert peaks.roofline_share(0, 67e12, 4.0) == 25.0


def test_trace_reader_busy_idle_and_ops():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW,
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 5,
         "dur": 30},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 45, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "gather_dot_cand_kernel<1>",
         "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "sort_kernel", "ts": 25,
         "dur": 15},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70,
         "dur": 10},
    ]
    t = devtrace.read_events(ev)
    assert abs(t.window_s - 100e-6) < 1e-12
    assert abs(t.busy_s - 40e-6) < 1e-12          # [10, 40] and [70, 80]
    assert abs(t.kernel_s("gather_dot_cand_kernel") - 20e-6) < 1e-12
    idle = dict(t.top_idle())
    assert abs(idle["aten::sort"] - 10e-6) < 1e-12     # [0, 10]
    assert abs(idle["cudaStreamSynchronize"] - 50e-6) < 1e-12
    assert t.top_ops()[0][0] == "gather_dot_cand_kernel<1>"
    assert devtrace.read_events(ev[1:]) is None
