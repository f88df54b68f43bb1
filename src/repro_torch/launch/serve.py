"""Serving launcher of Seismic (port of ``repro/launch/serve.py``):
builds an index over a synthetic collection, serves batched queries,
and reports recall against exact search, latency and docs evaluated.

  PYTHONPATH=src python -m repro_torch.launch.serve --n-docs 8192 --queries 256
  PYTHONPATH=src python -m repro_torch.launch.serve --doc-shards 4

The same flags, collection widths (96 non-zeros a doc, 32 a query),
index config and search parameters as the JAX launcher; the port's
``SearchParams`` defaults run the kernels (``use_kernel=True``,
``fuse_level=1``: summary_dot in the flat route, gather_dot_cand in the
selector and the scorer). ``--doc-shards N`` builds N shard indexes
(``build_sharded_index``) and answers in this process with
``search_shards``: the JAX launcher's shard_map over a host-device mesh
has no counterpart here (``make_distributed_search`` runs over
``torch.distributed`` ranks). ``--devices`` needs the port of
``distributed/`` (ROADMAP Queue 1, item 5) and raises.
"""
from __future__ import annotations

import argparse
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=8192)
    ap.add_argument("--dim", type=int, default=2048)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--budget", type=int, default=16)
    ap.add_argument("--cut", type=int, default=10)
    ap.add_argument("--devices", type=int, default=0,
                    help="a mesh of N devices: not ported (raises)")
    ap.add_argument("--doc-shards", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for tests)")
    return ap.parse_args(argv)


def search_params(args: argparse.Namespace, **kw):
    from repro_torch.retrieval import SearchParams
    return SearchParams(k=args.k, cut=args.cut, block_budget=args.budget,
                        policy="adaptive", **kw)


def serve(args: argparse.Namespace, docs, queries) -> dict:
    """Index ``docs`` and answer ``queries`` as the launcher does: returns
    ids [Q, k], their scores, docs_evaluated [Q], recall@k against
    ``exact_search`` and its ids, the seconds of the search (the index
    build not included) and the index (a ``ShardedIndex`` with
    ``--doc-shards``)."""
    import numpy as np
    import torch

    from repro_torch.core import SeismicConfig, build_index
    from repro_torch.core.baselines import exact_search
    from repro_torch.core.oracle import recall_at_k
    from repro_torch.kernels.runtime import sync_stream
    from repro_torch.serve.engine import SeismicServer

    icfg = SeismicConfig(lam=192, beta=12, alpha=0.4, block_cap=32,
                         summary_nnz=48)
    p = search_params(args)
    if args.doc_shards > 1:
        from repro_torch.core.distributed import (build_sharded_index,
                                                  search_shards)
        index = build_sharded_index(docs, icfg, args.doc_shards)
        t0 = time.perf_counter()
        scores, ids, evaluated = search_shards(index, queries, p)
        sync_stream(docs.device)
        dt = time.perf_counter() - t0
    else:
        index = build_index(docs, icfg, list_chunk=32)
        server = SeismicServer(index, p, max_batch=min(args.queries, 256))
        t0 = time.perf_counter()
        result = server.search(queries)
        dt = time.perf_counter() - t0
        ids, scores, evaluated = (result.ids, result.scores,
                                  result.docs_evaluated)
    _, exact_ids = exact_search(docs, queries, args.k)
    ids_np, exact_np = ids.cpu().numpy(), exact_ids.cpu().numpy()
    rec = float(np.mean([recall_at_k(ids_np[q], exact_np[q])
                         for q in range(ids_np.shape[0])]))
    return dict(ids=ids, scores=scores,
                docs_evaluated=evaluated.to(torch.int32), recall=rec,
                exact_ids=exact_ids, seconds=dt, index=index)


def main(argv=None) -> dict:
    """Run the launcher and print its lines; returns ``serve``'s dict and
    the ``queries``."""
    args = parse_args(argv)
    if args.devices:
        raise NotImplementedError(
            "--devices needs the port of distributed/ and launch/mesh.py "
            "(ROADMAP Queue 1, item 5); --doc-shards N answers in one "
            "process")
    from repro_torch.data import SyntheticSparseConfig, make_collection
    from repro_torch.device import resolve_device

    cfg = SyntheticSparseConfig(dim=args.dim, n_docs=args.n_docs,
                                n_queries=args.queries, doc_nnz=96,
                                query_nnz=32)
    docs, queries, _ = make_collection(cfg, device=resolve_device(args.device))
    out = serve(args, docs, queries)
    if args.doc_shards == 1:
        print(f"docs evaluated (mean): "
              f"{out['docs_evaluated'].float().mean():.0f}")
    dt = out["seconds"]
    print(f"{args.queries} queries in {dt*1000:.0f} ms "
          f"({dt/args.queries*1e6:.0f} us/query, includes the first "
          f"batch's kernel loading)  recall@{args.k}={out['recall']:.3f}")
    return dict(out, queries=queries)


if __name__ == "__main__":
    main()
