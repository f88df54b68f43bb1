"""Serving launcher of Seismic (port of ``repro/launch/serve.py``):
builds an index over a synthetic collection, serves batched queries,
and reports recall against exact search, latency and docs evaluated.

  PYTHONPATH=src python -m repro_torch.launch.serve --n-docs 8192 --queries 256
  PYTHONPATH=src python -m repro_torch.launch.serve --doc-shards 4
  PYTHONPATH=src python -m repro_torch.launch.serve --devices 8 --doc-shards 4

The same flags, collection widths (96 non-zeros a doc, 32 a query),
index config and search parameters as the JAX launcher; the port's
``SearchParams`` defaults run the kernels (``use_kernel=True``,
``fuse_level=1``: summary_dot in the flat route, gather_dot_cand in the
selector and the scorer). ``--doc-shards N`` alone builds N shard
indexes (``build_sharded_index``) and answers in this process with
``search_shards``. ``--devices N --doc-shards S`` is the JAX launcher's
mesh: N ranks as an ``(N / S, S)`` mesh of ("data", "model"), each
building its doc shard and answering through ``make_distributed_search``
(queries split over "data"). As the train launcher, ``--devices`` starts
the N ranks itself on this host, sharing ``--device`` over gloo; under
``torchrun`` each rank takes its own card (NCCL).
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
                    help="force host device count (testing only): N ranks "
                         "on this host sharing --device over gloo")
    ap.add_argument("--doc-shards", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for tests)")
    from repro_torch.launch.mesh import rank_args
    rank_args(ap)
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
    import torch

    from repro_torch.core import SeismicConfig, build_index
    from repro_torch.kernels.runtime import sync_stream
    from repro_torch.serve.engine import SeismicServer

    icfg = SeismicConfig(lam=192, beta=12, alpha=0.4, block_cap=32,
                         summary_nnz=48)
    p = search_params(args)
    if dist_ranks():
        return serve_ranks(args, docs, queries, icfg, p)
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
    rec, exact_ids = recall(args, docs, queries, ids)
    return dict(ids=ids, scores=scores,
                docs_evaluated=evaluated.to(torch.int32), recall=rec,
                exact_ids=exact_ids, seconds=dt, index=index)


def recall(args, docs, queries, ids):
    """(recall@k of ``ids`` against ``exact_search``, its ids)."""
    import numpy as np

    from repro_torch.core.baselines import exact_search
    from repro_torch.core.oracle import recall_at_k
    _, exact_ids = exact_search(docs, queries, args.k)
    ids_np, exact_np = ids.cpu().numpy(), exact_ids.cpu().numpy()
    return float(np.mean([recall_at_k(ids_np[q], exact_np[q])
                          for q in range(ids_np.shape[0])])), exact_ids


def dist_ranks() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist_ranks() else 0


def serve_ranks(args, docs, queries, icfg, p) -> dict:
    """This rank's part of the mesh run: an ``(N / S, S)`` mesh, the
    rank's doc shard built, ``make_distributed_search`` over every query
    (each rank returns the whole answer). ``launches`` is this rank's
    kernel launches in the search, ``rank_launches`` every rank's."""
    import torch.distributed as dist

    from repro_torch.core.build import build_index
    from repro_torch.core.distributed import (make_distributed_search,
                                              shard_collection)
    from repro_torch.kernels import runtime
    from repro_torch.kernels.runtime import sync_stream
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.sparse.ops import PaddedSparse
    mesh = make_mesh_for(dist.get_world_size(), args.doc_shards)
    shard = mesh.get_local_rank("model")
    sharded = shard_collection(docs, args.doc_shards)
    mine = PaddedSparse(sharded.coords[shard].clone(),
                        sharded.vals[shard].clone(), docs.dim)
    del sharded
    local = build_index(mine, icfg, list_chunk=32)
    search = make_distributed_search(mesh, p, doc_axes=("model",),
                                     data_axis="data", n_docs=docs.n)
    dist.barrier()
    runtime.reset_launches()
    t0 = time.perf_counter()
    scores, ids = search(local, queries.coords, queries.vals)
    sync_stream(docs.device)
    dt = time.perf_counter() - t0
    launches = dict(runtime.LAUNCHES)
    rank_launches = [None] * dist.get_world_size()
    dist.all_gather_object(rank_launches, launches)
    rec, exact_ids = recall(args, docs, queries, ids)
    return dict(ids=ids, scores=scores, recall=rec, exact_ids=exact_ids,
                seconds=dt, index=local,
                mesh=dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape))),
                backend=dist.get_backend(), launches=launches,
                rank_launches=rank_launches)


def main(argv=None) -> dict:
    """Run the launcher and print its lines; returns ``serve``'s dict and
    the ``queries``."""
    args = parse_args(argv)
    from repro_torch.launch.mesh import (join_ranks, join_torchrun,
                                         run_as_ranks, under_torchrun)
    if args.devices and args.rank is None:
        return run_as_ranks("repro_torch.launch.serve",
                            list(argv if argv is not None else
                                 __import__("sys").argv[1:]), args.devices)
    from repro_torch.data import SyntheticSparseConfig, make_collection
    from repro_torch.device import resolve_device

    if args.rank is not None:
        dev = join_ranks(args.rank, args.world, args.port, args.device)
    elif under_torchrun():
        dev = join_torchrun(args.device)
    else:
        dev = resolve_device(args.device)
    cfg = SyntheticSparseConfig(dim=args.dim, n_docs=args.n_docs,
                                n_queries=args.queries, doc_nnz=96,
                                query_nnz=32)
    docs, queries, _ = make_collection(cfg, device=dev)
    out = serve(args, docs, queries)
    rank0 = _rank() == 0
    if "mesh" in out and rank0:
        print(f"mesh={out['mesh']} backend={out['backend']} device={dev}")
    if args.doc_shards == 1 and "docs_evaluated" in out:
        print(f"docs evaluated (mean): "
              f"{out['docs_evaluated'].float().mean():.0f}")
    dt = out["seconds"]
    if rank0:
        print(f"{args.queries} queries in {dt*1000:.0f} ms "
              f"({dt/args.queries*1e6:.0f} us/query, includes the first "
              f"batch's kernel loading)  recall@{args.k}={out['recall']:.3f}",
              flush=True)
    out = dict(out, queries=queries)
    if dist_ranks():
        import torch
        import torch.distributed as dist
        if args.result is not None and rank0:
            torch.save({k: v for k, v in out.items() if k != "index"},
                       args.result)
        dist.barrier()
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
