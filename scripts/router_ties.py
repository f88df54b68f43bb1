#!/usr/bin/env python3
"""Where the kernel path and the plain path keep different blocks: exact
ties among router scores.

    python3 scripts/router_ties.py

Run from the repository root on a CUDA host (needs ``nvcc``). It makes
``chip_smoke.py``'s 1,048,576-doc collection and hierarchical index
with its kNN graph, and phase 12's 256 queries: the first 128 of the
collection's, then 128 drawn with the inserts' seed (another topic
vocabulary). For the flat ``SHAPES`` point and ``TUNED`` it runs the
kernel path (``use_kernel=True, fuse_level=1``) and the plain path
(``use_kernel=False, fuse_level=0``) stage by stage and prints, per
query half, the rows whose candidates and whose top-10 ids differ, the
largest relative gap between the two routers' scores, and, for the
rows that differ, how many distinct values their plain router scores
take over their live blocks: few distinct values are exact ties, which
another summation order breaks another way.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("router_ties: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core import build_index
    from repro_torch.data import SyntheticSparseConfig, make_collection
    from repro_torch.graph import build_doc_graph
    from repro_torch.kernels import runtime
    from repro_torch.retrieval import SearchParams, run_pipeline_staged
    from repro_torch.sparse.ops import PaddedSparse

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[ties] {cs.nvidia_smi_name_power()}", flush=True)
    runtime.build_kernels()
    docs, queries, _ = make_collection(SyntheticSparseConfig(
        dim=cs.DIM, n_docs=1 << 20, n_queries=cs.Q_BATCH,
        doc_nnz=cs.DOC_NNZ, query_nnz=cs.QUERY_NNZ, seed=0), device=dev)
    index = build_index(docs, dataclasses.replace(cs.ICFG, seed=0))
    index = build_doc_graph(index, degree=cs.GRAPH_DEGREE,
                            batch=cs.GRAPH_BATCH)
    half = cs.Q_ONLINE // 2
    _, new_q, _ = make_collection(SyntheticSparseConfig(
        dim=cs.DIM, n_docs=cs.MUT_INSERTS, n_queries=half,
        doc_nnz=cs.DOC_NNZ, query_nnz=cs.QUERY_NNZ, seed=1), device=dev)
    q = PaddedSparse(torch.cat([queries.coords[:half], new_q.coords]),
                     torch.cat([queries.vals[:half], new_q.vals]), cs.DIM)
    paths = {"flat": dict(k=10, cut=cs.CUT, block_budget=cs.BLOCK_BUDGET),
             "tuned": cs.TUNED}
    for name, kw in paths.items():
        out = {}
        for label, p in (("kernel", SearchParams(use_kernel=True,
                                                 fuse_level=1, **kw)),
                         ("plain", SearchParams(use_kernel=False,
                                                fuse_level=0, **kw))):
            seen: dict = {}
            res = run_pipeline_staged(index, q.coords, q.vals, p,
                                      probe=seen.__setitem__)
            out[label] = (res, seen)
        (kres, ks), (pres, ps) = out["kernel"], out["plain"]
        rk, rp = ks["router_r"], ps["router_r"]
        both = torch.isfinite(rk) & torch.isfinite(rp)
        gap = float(((rk - rp).abs() / rp.abs().clamp_min(1e-30))[both].max())
        cand = (torch.sort(ks["cand"], 1).values
                != torch.sort(ps["cand"], 1).values).any(1)
        ids = (kres[1] != pres[1]).any(1)
        for what, rows in (("the collection's", slice(0, half)),
                           ("the inserts' seed", slice(half, q.n))):
            differ = ids[rows].nonzero().flatten() + rows.start
            distinct = [(int(torch.unique(rp[r][torch.isfinite(rp[r])])
                             .numel()), int(torch.isfinite(rp[r]).sum()))
                        for r in differ.tolist()]
            print(f"[ties] {name}, {half} queries of {what}: candidates "
                  f"differ in {int(cand[rows].sum())} rows, top-10 ids in "
                  f"{differ.numel()}; plain router scores of those rows, "
                  f"distinct values / live blocks: {distinct}", flush=True)
        print(f"[ties] {name}: the routers' scores differ by at most "
              f"{gap:.3e} relative where both are finite", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
