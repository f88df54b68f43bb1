#!/usr/bin/env python3
"""Where the async server's launch time goes, on one GPU.

    python3 scripts/serving_overhead.py

Run from the repository root. It makes chip_smoke.py's 1,048,576-doc
index (superblock tier, kNN graph) and times ``SeismicServer(max_batch=8)``
answering one request at a time at ``TUNED`` (fuse 2), then serves
chip_smoke.py's phase-13 stream at ``TUNED`` (1,024 requests from 4
client threads, Poisson at twice that rate) through
``AsyncSeismicServer(max_batch=128)`` in three set-ups, each twice, in
the order bare, traced, audited, audited, traced, bare:

    bare      no observability, no auditor: every launch fused
    traced    ``Observability(stage_sample_every=16)``
    audited   that and a ``ShadowAuditor`` of every 4th launched request,
              as phase 13 runs it (an audited launch runs staged)

For each it prints QPS, the latency of requests not cached, the
telemetry's launch time (p50 and mean, upload to download) and the mean
launch span of staged and fused launches. Last, one bare run under
``torch.profiler`` gives the device's busy share over the run (the sum
of kernel time over the wall time) and the kernels by device time, or
"not measured" when the profiler records no device time.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("serving_overhead: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path.cwd() / "src"), str(Path.cwd())]
    import chip_smoke as cs
    from repro_torch.core.build import build_index
    from repro_torch.data import SyntheticSparseConfig, make_collection
    from repro_torch.graph import build_doc_graph
    from repro_torch.obs import Observability, ShadowAuditor
    from repro_torch.retrieval import SearchParams
    from repro_torch.serve import AsyncSeismicServer, SeismicServer

    dev = torch.device("cuda")
    smi = cs.nvidia_smi_name_power()
    print(f"[serving] {smi}", flush=True)
    docs, queries, _ = make_collection(SyntheticSparseConfig(
        dim=cs.DIM, n_docs=1 << 20, n_queries=cs.Q_ONLINE,
        doc_nnz=cs.DOC_NNZ, query_nnz=cs.QUERY_NNZ, seed=0), device=dev)
    index = build_index(docs, dataclasses.replace(cs.ICFG, seed=0))
    index = build_doc_graph(index, degree=cs.GRAPH_DEGREE,
                            batch=cs.GRAPH_BATCH)
    del docs
    p = SearchParams(use_kernel=True, fuse_level=2, **cs.TUNED)
    c, v = queries.coords.cpu().numpy(), queries.vals.cpu().numpy()

    sync = SeismicServer(index, p, max_batch=cs.ONLINE_BATCH)
    for i in range(8):                                   # warm
        sync.search(queries[i:i + 1]).ids.cpu()
    t0 = time.perf_counter()
    for i in range(cs.SYNC_REQUESTS):
        sync.search(queries[i:i + 1]).ids.cpu()
    per = (time.perf_counter() - t0) / cs.SYNC_REQUESTS
    rate = 2 / per
    units = cs.serving_traffic(0)
    print(f"[serving] one request at a time: {per * 1e3:.3f} ms a request; "
          f"offered {rate:.1f} requests/s", flush=True)

    def serve(setup: str, profile=None):
        obs = None if setup == "bare" else Observability.create(
            trace_capacity=2 * cs.SERVE_REQUESTS,
            stage_sample_every=cs.STAGE_SAMPLE)
        auditor = None
        if setup == "audited":
            auditor = ShadowAuditor(index, p, obs.registry,
                                    audit_sample_every=cs.AUDIT_EVERY,
                                    queue_bound=cs.SERVE_REQUESTS,
                                    window=cs.SERVE_REQUESTS).start()
        srv = AsyncSeismicServer(
            index, p, max_batch=cs.SERVE_MAX_BATCH, query_nnz=cs.QUERY_NNZ,
            deadline_s=cs.SERVE_DEADLINE, queue_bound=cs.SERVE_QUEUE,
            cache_size=cs.SERVE_CACHE, obs=obs, auditor=auditor)
        try:
            srv.start()
            if profile is not None:
                profile.start()
            subs, secs, sent = cs.drive_clients(srv, units, c, v, rate, 0)
            if profile is not None:
                torch.cuda.synchronize()
                profile.stop()
        finally:
            srv.stop()
            if auditor is not None:
                auditor.drain()
                auditor.close()
        cs.check_answers(setup, subs, {0: ref})
        launch = srv.telemetry_export()["latency_s"]["launch"]
        spans = cs.launch_means(obs.tracer) if obs is not None else "-"
        print(f"[serving] {setup}: {cs.latency_line(subs, secs, sent)}; "
              "launch "
              f"p50 {launch['p50'] * 1e3:.3f} ms, mean "
              f"{launch['mean'] * 1e3:.3f} ms over {launch['count']}; "
              f"launch spans {spans}", flush=True)
        return secs

    r = SeismicServer(index, p, max_batch=cs.Q_ONLINE).search(queries)
    ref = tuple(t.cpu().numpy() for t in (r.scores, r.ids,
                                           r.docs_evaluated))
    for setup in ("bare", "traced", "audited", "audited", "traced",
                  "bare"):
        serve(setup)

    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    secs = serve("bare", prof)
    events = prof.key_averages()

    def device_us(e) -> float:
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))
    busy = sum(device_us(e) for e in events)
    if busy <= 0:
        print("[serving] profiled bare run: device busy share not measured "
              "(the profiler recorded no device time)", flush=True)
        return 0
    top = sorted(events, key=device_us, reverse=True)[:8]
    print(f"[serving] profiled bare run: device busy {busy / 1e3:.1f} ms of "
          f"{secs * 1e3:.1f} ms wall, share {busy / 1e6 / secs:.4f}; top: "
          + ", ".join(f"{e.key[:40]} {device_us(e) / 1e3:.2f} ms"
                      for e in top), flush=True)
    print(f"[serving] {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
