#!/usr/bin/env python3
"""Median stage times of the hierarchical, refined path on one GPU.

    python3 <checkout>/scripts/stage_medians.py

Run from the root of the checkout to measure (it imports that
directory's ``src`` and ``chip_smoke.py``, so the same file can measure
another checkout, e.g. a parent commit unpacked beside this one). It
makes chip_smoke.py's 1,048,576-doc collection and index with the
superblock tier and the kNN graph, then at 256 and 4096 queries runs
``run_pipeline_staged`` at ``CONFIG_TUNED``'s 0.95 point and fuse level
2 ten times (after two warm-up runs) and prints each stage's median
ms, host clock to a synchronize per stage, as chip_smoke.py's phase 7
times one run; and refine_round's first round, 50 launches back to
back between two CUDA events (L2 warm, as the pipeline finds it).
"""
from __future__ import annotations

import dataclasses
import statistics
import sys
from pathlib import Path


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("stage_medians: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path.cwd() / "src"), str(Path.cwd())]
    import chip_smoke as cs
    from repro_torch.core.build import build_index
    from repro_torch.data import SyntheticSparseConfig, make_collection
    from repro_torch.graph import build_doc_graph
    from repro_torch.graph.refine import scored_init
    from repro_torch.kernels.refine_fused.ops import refine_round_batch
    from repro_torch.retrieval import SearchParams, run_pipeline_staged
    from repro_torch.retrieval.prep import prep_queries

    dev = torch.device("cuda")
    print(f"[stages] {Path.cwd().name}: {cs.nvidia_smi_name_power()}",
          flush=True)
    docs, queries, _ = make_collection(SyntheticSparseConfig(
        dim=cs.DIM, n_docs=1 << 20, n_queries=cs.Q_BATCH,
        doc_nnz=cs.DOC_NNZ, query_nnz=cs.QUERY_NNZ, seed=0), device=dev)
    index = build_index(docs, dataclasses.replace(cs.ICFG, seed=0))
    index = build_doc_graph(index, degree=cs.GRAPH_DEGREE,
                            batch=cs.GRAPH_BATCH)
    p = SearchParams(use_kernel=True, fuse_level=2, **cs.TUNED)
    for qn in (cs.Q_ONLINE, cs.Q_BATCH):
        qs = queries[:qn]
        runs: dict[str, list[float]] = {}
        for i in range(12):
            st: dict[str, float] = {}
            run_pipeline_staged(index, qs.coords, qs.vals, p,
                                record=st.__setitem__, split_refine=True)
            for k, v in st.items():
                if i >= 2:
                    runs.setdefault(k, []).append(v * 1e3)
        print(f"[stages] Q={qn} median ms of 10: " + ", ".join(
            f"{k} {statistics.median(v):.3f}" for k, v in runs.items()),
            flush=True)
        seen: dict[str, object] = {}
        run_pipeline_staged(index, qs.coords, qs.vals, p,
                            probe=seen.__setitem__, audit=True)
        ids = seen["merge_ids"]
        qh, _, _ = prep_queries(qs.coords, qs.vals, index.dim, p.cut)
        f_in = (ids, scored_init(ids, index.n_docs), qh, index.knn_ids,
                index.fwd.coords, index.fwd.vals)
        for _ in range(3):
            refine_round_batch(*f_in, n_docs=index.n_docs,
                               degree=p.graph_degree)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            refine_round_batch(*f_in, n_docs=index.n_docs,
                               degree=p.graph_degree)
        end.record()
        end.synchronize()
        print(f"[stages] Q={qn} refine_round, first round, back to back: "
              f"{start.elapsed_time(end) / 50:.4f} ms a launch", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
