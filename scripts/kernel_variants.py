#!/usr/bin/env python3
"""Time design variants of router_flat and refine_round on one GPU.

    python3 scripts/kernel_variants.py

Run from the repository root on a machine with one CUDA device and
``nvcc``. The script makes chip_smoke.py's 1,048,576-doc collection and
its index (flat tier, kNN graph of degree 8), takes router_flat's inputs
at 256 and 4096 queries and refine_round's first round at 256 queries
(as phase 8 does), and for each variant below writes a patched copy of
the kernel's source under ``build/variants/``, compiles it with the
runtime's nvcc flags, loads it with ctypes and times its C entry point
on those inputs with ``chip_smoke.Bench`` (L2 flushed before each
launch), in two rounds of all variants. A patch replaces text that must
occur in the source exactly once; the checked-in kernels stay as they
are. Each line it prints is one variant's time in both rounds.

router_flat (``router_fused.cu``):
* as built;
* query by query: every group scored one query at a time with q looked
  up in L2 (the group table never used);
* records after groups: the records kernel launched after the groups
  kernel instead of beside it;
* one issuing lane: the producer's lane 0 issues all five ranges of a
  tile (coords, levels, scales, zeros, block_len) instead of five lanes
  one each;
* streaming only (a probe, its scores wrong): the ring and the group
  tables as built, no row scored;
* clock64 breakdown (a probe): as built, plus per-warp cycle counts of
  the consumers (waiting for records, building the table, waiting for
  tiles, scoring) and the producer (waiting for ring slots and for the
  consumers), printed for one flushed launch.

refine_round (``refine_fused.cu``, bf16 values, int32 coords):
* as built; 8 warps a block; 2 rows a warp at once;
* q row prefetched: the 15 warps idle during the sorts ask L2 for the
  query's whole q_dense row;
* no q lookups (a probe, its scores wrong): q read as a constant;
* no rescoring (a probe): the frontier only.
"""
from __future__ import annotations

import ctypes
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "variants"

# clock64 probes of router_flat_kernel: (text, replacement)
ROUTER_CLOCKS = [
    ('#include "row_tiles.cuh"\n',
     '#include "row_tiles.cuh"\n__device__ unsigned long long g_clk[16];\n'
     'extern "C" int clocks_read(unsigned long long* h) {\n'
     '  cudaMemcpyFromSymbol(h, g_clk, 128);\n'
     '  unsigned long long z[16] = {0};\n'
     '  return (int)cudaMemcpyToSymbol(g_clk, z, 128);\n}\n'),
    ("    const int n_groups = ctrl[0];\n    int k = 0;",
     "    const int n_groups = ctrl[0];\n    int k = 0;\n"
     "    long long P0 = clock64(), pe = 0, pg = 0;"),
    ("          seismic::mbar_wait(empty + k % kTileStages,\n"
     "                             (k / kTileStages - 1) & 1);",
     "          { long long _t = clock64(); seismic::mbar_wait(empty + k % "
     "kTileStages, (k / kTileStages - 1) & 1); pe += clock64() - _t; }"),
    ("      if (gi >= 2)              // consumers are done with group "
     "gi - 2\n"
     "        seismic::mbar_wait(gempty + b, ((gi >> 1) - 1) & 1);",
     "      { long long _t = clock64(); if (gi >= 2) seismic::mbar_wait("
     "gempty + b, ((gi >> 1) - 1) & 1); pg += clock64() - _t; }"),
    ("        seismic::mbar_arrive(gfull + b);\n        return;",
     "        seismic::mbar_arrive(gfull + b);\n        if (lane == 0) {\n"
     "          atomicAdd(&g_clk[5], (unsigned long long)pe);\n"
     "          atomicAdd(&g_clk[6], (unsigned long long)pg);\n"
     "          atomicAdd(&g_clk[9], (unsigned long long)(clock64() - P0));\n"
     "          atomicAdd(&g_clk[10], (unsigned long long)gi);\n        }\n"
     "        return;"),
    ("  int k = 0;                                // ---- the consumers",
     "  int k = 0;\n  long long C0 = clock64(), cg = 0, cf = 0, cs = 0;"),
    ("    seismic::mbar_wait(gfull + b, (gi >> 1) & 1);\n"
     "    const FlatDesc* ds = desc + b;\n    const int n = ds->n;\n"
     "    if (n < 0) return;",
     "    { long long _t = clock64(); seismic::mbar_wait(gfull + b, (gi >> 1)"
     " & 1); cg += clock64() - _t; }\n    const FlatDesc* ds = desc + b;\n"
     "    const int n = ds->n;\n    if (n < 0) {\n      if (lane == 0) {\n"
     "        atomicAdd(&g_clk[0], (unsigned long long)cg);\n"
     "        atomicAdd(&g_clk[1], (unsigned long long)cf);\n"
     "        atomicAdd(&g_clk[2], (unsigned long long)cs);\n"
     "        atomicAdd(&g_clk[8], (unsigned long long)(clock64() - C0));\n"
     "        atomicAdd(&g_clk[11], (unsigned long long)k);\n      }\n"
     "      return;\n    }"),
    ("    const bool table = build_union(rb, record_stride, n, nwp, ut, "
     "ul);\n",
     "    long long _u = clock64();\n"
     "    const bool table = build_union(rb, record_stride, n, nwp, ut, "
     "ul);\n"
     "    if (lane == 0) atomicAdd(&g_clk[3], (unsigned long long)(clock64() -"
     " _u));\n"),
    ("      seismic::mbar_wait(full + k % kTileStages, (k / kTileStages) & 1);"
     "\n      const unsigned char* src = slot(k);\n"
     "      const int rows = min(tile_rows, n_live",
     "      { long long _t = clock64(); seismic::mbar_wait(full + k % "
     "kTileStages, (k / kTileStages) & 1); cf += clock64() - _t; }\n"
     "      const unsigned char* src = slot(k);\n"
     "      const int rows = min(tile_rows, n_live"),
    ("      if (table) {\n        // the group's",
     "      long long _s = clock64();\n      if (table) {\n"
     "        // the group's"),
    ("      __syncwarp();\n"
     "      if (lane == 0) seismic::mbar_arrive(empty + k % kTileStages);\n"
     "    }\n    // the dead rows",
     "      cs += clock64() - _s;\n      __syncwarp();\n"
     "      if (lane == 0) seismic::mbar_arrive(empty + k % kTileStages);\n"
     "    }\n    // the dead rows"),
]

ROUTER = {
    "as built": [],
    "query by query": [
        ("build_union(rb, record_stride, n, nwp, ut, ul);",
         "build_union(rb, record_stride, n, nwp, ut, ul) && false;")],
    "records after groups": [
        ('  asm volatile("griddepcontrol.launch_dependents;\\n" ::: '
         '"memory");', ""),
        ("  attr.val.programmaticStreamSerializationAllowed = 1;",
         "  attr.val.programmaticStreamSerializationAllowed = 0;")],
    "one issuing lane": [
        ("        if (lane < 5) {\n          const int rows",
         "        if (lane < 1) {\n          const int rows"),
        ("          seismic::mbar_expect_tx(\n"
         "              bar, seismic::bulk_part(\n"
         "                       reinterpret_cast<uintptr_t>(src[lane]), "
         "bytes[lane]));\n"
         "          seismic::copy_range(slot(k) + at[lane], src[lane], "
         "bytes[lane],\n                              bar);",
         "          for (int x = 0; x < 5; ++x) {\n"
         "            seismic::mbar_expect_tx(bar, seismic::bulk_part("
         "reinterpret_cast<uintptr_t>(src[x]), bytes[x]));\n"
         "            seismic::copy_range(slot(k) + at[x], src[x], bytes[x], "
         "bar);\n          }")],
    "streaming only": [
        ("      if (table) {\n        // the group's",
         "      if (false) {\n        // the group's"),
        ("        for (int j = 0; j < n; ++j) {",
         "        for (int j = 0; j < 0; ++j) {")],
    "clock64 breakdown": ROUTER_CLOCKS,
}

REFINE = {
    "as built": [],
    "8 warps a block": [("constexpr int kWarps = 16; ",
                         "constexpr int kWarps = 8; ")],
    "2 rows a warp": [("constexpr int kRows = 4; ",
                       "constexpr int kRows = 2; ")],
    "q row prefetched": [
        ("    if (lane == 0) n_live = live;\n  }\n  __syncthreads();",
         "    if (lane == 0) n_live = live;\n  } else {\n"
         "    const char* row = reinterpret_cast<const char*>(q + qi * d);\n"
         "    for (long long b = (long long)(threadIdx.x - 32) * 128; "
         "b < 4LL * d; b += (kThreads - 32) * 128)\n"
         "      asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(row + b));\n"
         "  }\n  __syncthreads();")],
    "no q lookups": [
        ("using seismic::row_dots;",
         "using seismic::row_dots;\nstruct ConstQ {\n"
         "  __device__ float operator()(int c) const { return c * 1e-30f; }\n"
         "};"),
        ("  const QRow qv{q + qi * d};", "  const ConstQ qv{};")],
    "no rescoring": [("i0 < nl; i0 += kWarps * kRows",
                      "i0 < 0; i0 += kWarps * kRows")],
}


def build(runtime, name: str, family: str, patches) -> subprocess.Popen:
    src = runtime.SOURCES[family].read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"{family} / {name}: the text to patch is not "
                               f"in the source exactly once: {old[:60]!r}")
        src = src.replace(old, new)
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)
    path = OUT / f"{family}_{tag}.cu"
    path.write_text(src)
    return subprocess.Popen(
        [runtime._nvcc(), *runtime.NVCC_FLAGS, "-o", str(path.with_suffix(
            ".so")), str(path)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def load(family: str, name: str) -> ctypes.CDLL:
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)
    lib = ctypes.CDLL(str(OUT / f"{family}_{tag}.so"))
    v, i = ctypes.c_void_p, ctypes.c_int
    if family == "router_fused":
        lib.router_flat_launch.argtypes = [v] * 9 + [i] * 7 + [v]
        lib.router_flat_launch.restype = i
    else:
        lib.refine_round_launch.argtypes = [v] * 10 + [i] * 10 + [v]
        lib.refine_round_launch.restype = i
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core.build import build_index
    from repro_torch.data import SyntheticSparseConfig, make_collection
    from repro_torch.graph import build_doc_graph
    from repro_torch.graph.refine import scored_init
    from repro_torch.kernels import runtime
    from repro_torch.kernels.gather_dot.ops import _COORD_KIND, _VAL_KIND
    from repro_torch.kernels.refine_fused.ops import refine_round_batch
    from repro_torch.kernels.router_fused.ops import flat_geometry
    from repro_torch.retrieval import SearchParams, run_pipeline_staged
    from repro_torch.retrieval.prep import prep_queries

    print(f"[variants] {cs.nvidia_smi_name_power()}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {("router_fused", n): build(runtime, n, "router_fused", p)
             for n, p in ROUTER.items()}
    procs.update({("refine_fused", n): build(runtime, n, "refine_fused", p)
                  for n, p in REFINE.items()})
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    docs, queries, _ = make_collection(SyntheticSparseConfig(
        dim=cs.DIM, n_docs=1 << 20, n_queries=cs.Q_BATCH,
        doc_nnz=cs.DOC_NNZ, query_nnz=cs.QUERY_NNZ, seed=0), device=dev)
    index = build_index(docs, dataclasses.replace(
        cs.ICFG, superblock_fanout=0, seed=0))
    index = build_doc_graph(index, degree=cs.GRAPH_DEGREE,
                            batch=cs.GRAPH_BATCH)
    torch.cuda.synchronize()
    print(f"[variants] index and graph in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key}: nvcc failed\n{log}")
    bench = cs.Bench(torch, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = runtime.stream_of(queries.vals)
    lines: dict[str, list[float]] = {}

    # router_flat at the flat path's 256 and 4096 queries
    l, nb, s = index.sum_coords.shape
    for qn in (cs.Q_ONLINE, cs.Q_BATCH):
        qs = queries[:qn]
        qd, lists, _ = prep_queries(qs.coords, qs.vals, index.dim, cs.CUT)
        ins = (lists, qd, index.sum_coords, index.sum_q, index.sum_scale,
               index.sum_zero, index.block_len)
        g = flat_geometry(qn, cs.CUT, l, nb, s, index.dim, sms)
        scratch = torch.empty(g["scratch_words"], dtype=torch.int32,
                              device=dev)
        out = torch.empty((qn, cs.CUT * nb), device=dev)
        for rnd in range(2):
            for name in ROUTER:
                lib = load("router_fused", name)
                fn = lambda lib=lib: lib.router_flat_launch(  # noqa: E731
                    *map(runtime.ptr, ins), runtime.ptr(out),
                    runtime.ptr(scratch), qn, cs.CUT, l, nb, s, index.dim,
                    sms, stream)
                lines.setdefault(f"router_flat Q={qn} {name}", []).append(
                    bench.ms(fn, iters=10))
                if name == "clock64 breakdown" and rnd == 0:
                    lib.clocks_read.argtypes = [ctypes.c_void_p]
                    h = (ctypes.c_ulonglong * 16)()
                    lib.clocks_read(h)            # zero after the timing
                    bench.flush.zero_()
                    fn()
                    torch.cuda.synchronize()
                    lib.clocks_read(h)
                    cw = g["grid"] * 8
                    kc = [x / 1e3 for x in h]
                    print(f"[variants] router_flat Q={qn} clock64, thousand "
                          f"cycles per consumer warp: total {kc[8] / cw:.1f}, "
                          f"waiting for records {kc[0] / cw:.1f}, "
                          f"building the table {kc[3] / cw:.1f}, waiting "
                          f"for tiles {kc[1] / cw:.1f}, scoring "
                          f"{kc[2] / cw:.1f} ({h[11] / cw:.1f} tiles); per "
                          f"producer: waiting for ring slots "
                          f"{kc[5] / g['grid']:.1f}, for the consumers "
                          f"{kc[6] / g['grid']:.1f} "
                          f"({h[10] / g['grid']:.1f} groups)", flush=True)

    # refine_round's first round on the hierarchical path's 256 queries,
    # here over the flat index (the same graph and forward plane)
    p = SearchParams(use_kernel=True, fuse_level=2, k=10, cut=8,
                     block_budget=128, policy="budget",
                     graph_degree=cs.GRAPH_DEGREE, refine_rounds=2)
    q256 = queries[:cs.Q_ONLINE]
    seen: dict[str, object] = {}
    run_pipeline_staged(index, q256.coords, q256.vals, p,
                        probe=seen.__setitem__, audit=True)
    ids = seen["merge_ids"]
    qh, _, _ = prep_queries(q256.coords, q256.vals, index.dim, 8)
    f_in = (ids, scored_init(ids, index.n_docs), qh, index.knn_ids,
            index.fwd.coords, index.fwd.vals)
    cand, _ = refine_round_batch(*f_in, n_docs=index.n_docs,
                                 degree=cs.GRAPH_DEGREE)
    live = float((cand < index.n_docs).sum()) / qh.shape[0]
    print(f"[variants] refine_round: {live:.1f} live frontier ids a query",
          flush=True)
    qn, k = ids.shape
    c_t = torch.empty((qn, k * cs.GRAPH_DEGREE), dtype=torch.int32,
                      device=dev)
    o_t = torch.empty((qn, k * cs.GRAPH_DEGREE), device=dev)
    args = [*map(runtime.ptr, f_in), runtime.ptr(None), runtime.ptr(None),
            runtime.ptr(c_t), runtime.ptr(o_t)]
    for _ in range(2):
        for name in REFINE:
            lib = load("refine_fused", name)
            fn = lambda lib=lib: lib.refine_round_launch(  # noqa: E731
                *args, qn, k, f_in[1].shape[1], cs.GRAPH_DEGREE,
                index.knn_ids.shape[1], index.n_docs,
                index.fwd.coords.shape[1], index.dim,
                _COORD_KIND[index.fwd.coords.dtype],
                _VAL_KIND[index.fwd.vals.dtype], stream)
            lines.setdefault(f"refine_round Q=256 {name}", []).append(
                bench.ms(fn, iters=20))
    for label, ms in lines.items():
        print(f"[variants] {label}: " + ", ".join(f"{t:.4f}" for t in ms)
              + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
