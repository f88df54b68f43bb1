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

refine_round's warp route (``refine_fused.cu``, bf16 values, int32
coords), on the flat path's first round at 256 queries:
* as built; 8 warps a block; 2 rows a warp at once;
* q row prefetched: the 15 warps idle during the sorts ask L2 for the
  query's whole q_dense row;
* no q lookups (a probe, its scores wrong): q read as a constant;
* no rescoring (a probe): the frontier only.

refine_round's block route (more than 512 candidates a query), on
chip_smoke.py phase 7's path at ``TUNED`` with k ``DEEP_K`` (800
candidates a query), its first round, at 256 and 4096 queries:
* as built;
* clock64 breakdown (a probe): as built, plus each block's cycles in
  expand, sort 1, marking duplicates and seen ids, the compaction (sort 2
  or its replacement) and rescoring, averaged over the blocks of one
  flushed launch, with the blocks an SM holds
  (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the waves a
  batch takes;
* 1 block an SM: the launch bound without its minimum of 2 blocks;
* seen row read at the marking: no early load of the seen row's first
  ids;
* no rescoring (a probe): the frontier only.
The block route's patches are written for each design of the kernel
(``BLOCK_DESIGNS``, told apart by their text), so that the script, copied
into an older checkout, measures that checkout's kernel alike; a variant
written for the other design only is not run and says so.
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
    "no rescoring": [("  const QRow qv{q + qi * d};\n",
                      "  const QRow qv{q + qi * d};\n  nl = 0;\n")],
}

# the block route's clock64 probe, common to both designs: thread 0 adds
# its stage cycles T1-T0 .. T5-T4 and one block to g_clk after a barrier
# that closes the rescoring; clocks_occupancy gives the blocks an SM
# holds of the bf16 / int32 instantiation at a dynamic shared memory
BLOCK_CLOCK_SYMBOLS = (
    '#include "row_dot.cuh"\n',
    '#include "row_dot.cuh"\n__device__ unsigned long long g_clk[8];\n'
    'extern "C" int clocks_read(unsigned long long* h) {\n'
    '  cudaMemcpyFromSymbol(h, g_clk, 64);\n'
    '  unsigned long long z[8] = {0};\n'
    '  return (int)cudaMemcpyToSymbol(g_clk, z, 64);\n}\n')
BLOCK_CLOCK_REPORT = (
    "  __syncthreads();\n  if (threadIdx.x == 0) {\n"
    "    const long long T5 = clock64();\n"
    "    atomicAdd(&g_clk[0], (unsigned long long)(T1 - T0));\n"
    "    atomicAdd(&g_clk[1], (unsigned long long)(T2 - T1));\n"
    "    atomicAdd(&g_clk[2], (unsigned long long)(T3 - T2));\n"
    "    atomicAdd(&g_clk[3], (unsigned long long)(T4 - T3));\n"
    "    atomicAdd(&g_clk[4], (unsigned long long)(T5 - T4));\n"
    "    atomicAdd(&g_clk[5], 1ull);\n  }\n")
BLOCK_OCCUPANCY = (
    'extern "C" int refine_empty_launch(cudaStream_t stream) {',
    'extern "C" int clocks_occupancy(int smem) {\n  int n = 0;\n'
    '  cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n'
    '      &n, refine_block_kernel<int32_t, __nv_bfloat16, false>, kThreads,'
    ' smem);\n  return n;\n}\n\n'
    'extern "C" int refine_empty_launch(cudaStream_t stream) {')
TWO_SORTS = "two block-wide sorts"
WARP_STEPS = "warp-local sort steps, a scan compacts"
BLOCK_CLOCKS = {
    TWO_SORTS: [
        BLOCK_CLOCK_SYMBOLS, BLOCK_OCCUPANCY,
        ("  // ---- 1. expand\n  for (int t = threadIdx.x; t < P;",
         "  const long long T0 = clock64();\n"
         "  // ---- 1. expand\n  for (int t = threadIdx.x; t < P;"),
        ("  __syncthreads();\n  block_sort(key, P);\n  // ---- 2. duplicates",
         "  __syncthreads();\n  const long long T1 = clock64();\n"
         "  block_sort(key, P);\n  const long long T2 = clock64();\n"
         "  // ---- 2. duplicates"),
        ("  __syncthreads();\n  // ---- 4. compact\n  block_sort(key, P);\n"
         "  if (threadIdx.x == 0) *n_live = first_at_least(key, n_cand, "
         "n_docs);\n  __syncthreads();\n",
         "  __syncthreads();\n  const long long T3 = clock64();\n"
         "  // ---- 4. compact\n  block_sort(key, P);\n"
         "  if (threadIdx.x == 0) *n_live = first_at_least(key, n_cand, "
         "n_docs);\n  __syncthreads();\n  const long long T4 = clock64();\n"),
        ("  rescore<C, V, kQuant>(key, *n_live, n_cand, qi, q, fwd_coords, "
         "fwd_vals,\n                        fwd_scale, fwd_zero, cand, out, "
         "nnz, d);\n}",
         "  rescore<C, V, kQuant>(key, *n_live, n_cand, qi, q, fwd_coords, "
         "fwd_vals,\n                        fwd_scale, fwd_zero, cand, out, "
         "nnz, d);\n" + BLOCK_CLOCK_REPORT + "}")],
    # the expansion and the first sort steps are warp-local here: the
    # probe adds a barrier between them so that thread 0 times the block
    WARP_STEPS: [
        BLOCK_CLOCK_SYMBOLS, BLOCK_OCCUPANCY,
        ("  // ---- 1. expand, each warp into its own chunk\n",
         "  const long long T0 = clock64();\n"
         "  // ---- 1. expand, each warp into its own chunk\n"),
        ("  __syncwarp();\n  block_sort<kWarps>(key, P);\n"
         "  __syncthreads();\n",
         "  __syncthreads();\n  const long long T1 = clock64();\n"
         "  block_sort<kWarps>(key, P);\n  __syncthreads();\n"
         "  const long long T2 = clock64();\n"),
        ("  __syncthreads();\n  // ---- 4. compact by a scan",
         "  __syncthreads();\n  const long long T3 = clock64();\n"
         "  // ---- 4. compact by a scan"),
        ("key[t] = n_docs;\n  __syncthreads();\n",
         "key[t] = n_docs;\n  __syncthreads();\n"
         "  const long long T4 = clock64();\n"),
        ("      out, nnz, d);\n}", "      out, nnz, d);\n" + BLOCK_CLOCK_REPORT
         + "}")],
}
# a design is told apart by text that only its source holds
BLOCK_DESIGNS = {TWO_SORTS: "  // ---- 4. compact\n  block_sort(key, P);",
                 WARP_STEPS: "  // ---- 4. compact by a scan"}

REFINE_BLOCK = {
    "as built": {d: [] for d in BLOCK_DESIGNS},
    "clock64 breakdown": BLOCK_CLOCKS,
    # the launch bound of one block an SM: the registers not held to 64
    "1 block an SM": {WARP_STEPS: [
        ("constexpr int kBlockRouteBlocksPerSm = 2;",
         "constexpr int kBlockRouteBlocksPerSm = 1;")]},
    # the seen row's first ids read where they are searched, not at the
    # kernel's start
    "seen row read at the marking": {WARP_STEPS: [
        ("    const int v = s == threadIdx.x ? seen0 : seen[s];",
         "    const int v = seen[s];")]},
    "no rescoring (a probe)": {d: REFINE["no rescoring"]
                               for d in (TWO_SORTS, WARP_STEPS)},
}


def block_design(runtime) -> str:
    src = runtime.SOURCES["refine_fused"].read_text()
    found = [d for d, text in BLOCK_DESIGNS.items() if text in src]
    if len(found) != 1:
        raise RuntimeError(f"refine_fused.cu: the block route's design is "
                           f"not one of {list(BLOCK_DESIGNS)}")
    return found[0]


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
    from repro_torch.kernels.refine_fused.ops import (block_smem,
                                                      refine_round_batch)
    from repro_torch.kernels.router_fused.ops import flat_geometry
    from repro_torch.retrieval import SearchParams, run_pipeline_staged
    from repro_torch.retrieval.prep import prep_queries

    print(f"[variants] {cs.nvidia_smi_name_power()}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {("router_fused", n): build(runtime, n, "router_fused", p)
             for n, p in ROUTER.items()}
    procs.update({("refine_fused", n): build(runtime, n, "refine_fused", p)
                  for n, p in REFINE.items()})
    design = block_design(runtime)
    block_variants = [n for n, by in REFINE_BLOCK.items() if design in by]
    print(f"[variants] refine_round's block route: {design}; not written "
          f"for it: {[n for n in REFINE_BLOCK if n not in block_variants]}",
          flush=True)
    procs.update({("refine_fused", "block " + n): build(
        runtime, "block " + n, "refine_fused", REFINE_BLOCK[n][design])
        for n in block_variants})
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    docs, queries, _ = make_collection(SyntheticSparseConfig(
        dim=cs.DIM, n_docs=1 << 20, n_queries=cs.Q_BATCH,
        doc_nnz=cs.DOC_NNZ, query_nnz=cs.QUERY_NNZ, seed=0), device=dev)
    # phase 5's index (its superblocks serve phase 7's TUNED path; the
    # flat path's router and refine inputs ignore them)
    index = build_index(docs, dataclasses.replace(cs.ICFG, seed=0))
    index = build_doc_graph(index, degree=cs.GRAPH_DEGREE,
                            batch=cs.GRAPH_BATCH)
    torch.cuda.synchronize()
    print(f"[variants] index and graph in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key}: nvcc failed\n{log}")
        if key == ("refine_fused", "block as built"):
            for line in cs.ptxas_lines(log):
                if line.startswith("refine_block"):
                    print(f"[variants] {line}", flush=True)
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

    # refine_round's first round on the flat path's 256 queries (the
    # same graph and forward plane as the hierarchical path's)
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

    # the block route on phase 7's k DEEP_K path, its first round
    deep = SearchParams(use_kernel=True, fuse_level=2,
                        **{**cs.TUNED, "k": cs.DEEP_K})
    for qn in (cs.Q_ONLINE, cs.Q_BATCH):
        qs = queries[:qn]
        seen = {}
        run_pipeline_staged(index, qs.coords, qs.vals, deep,
                            probe=seen.__setitem__, audit=True)
        ids = seen.pop("merge_ids")
        del seen
        qh, _, _ = prep_queries(qs.coords, qs.vals, index.dim, deep.cut)
        f_in = (ids, scored_init(ids, index.n_docs), qh, index.knn_ids,
                index.fwd.coords, index.fwd.vals)
        c = cs.DEEP_K * cs.GRAPH_DEGREE
        cand, _ = refine_round_batch(*f_in, n_docs=index.n_docs,
                                     degree=cs.GRAPH_DEGREE)
        live = float((cand < index.n_docs).sum()) / qn
        smem = block_smem(c)
        per_sm = load("refine_fused", "block clock64 breakdown")
        per_sm.clocks_occupancy.argtypes = [ctypes.c_int]
        held = per_sm.clocks_occupancy(smem)
        print(f"[variants] refine_round block route Q={qn} k={cs.DEEP_K}: "
              f"{live:.1f} live frontier ids a query of {c}; {held} blocks "
              f"an SM at {smem} B of dynamic shared memory: "
              f"{-(-qn // max(held * sms, 1))} waves", flush=True)
        c_t = torch.empty((qn, c), dtype=torch.int32, device=dev)
        o_t = torch.empty((qn, c), device=dev)
        args = [*map(runtime.ptr, f_in), runtime.ptr(None),
                runtime.ptr(None), runtime.ptr(c_t), runtime.ptr(o_t)]
        for rnd in range(2):
            for name in block_variants:
                lib = load("refine_fused", "block " + name)
                c_t.fill_(-7)
                fn = lambda lib=lib: lib.refine_round_launch(  # noqa: E731
                    *args, qn, cs.DEEP_K, f_in[1].shape[1], cs.GRAPH_DEGREE,
                    index.knn_ids.shape[1], index.n_docs,
                    index.fwd.coords.shape[1], index.dim,
                    _COORD_KIND[index.fwd.coords.dtype],
                    _VAL_KIND[index.fwd.vals.dtype], stream)
                lines.setdefault(f"refine_round block route Q={qn} {name}",
                                 []).append(bench.ms(fn, iters=20))
                if not torch.equal(c_t, cand):
                    raise AssertionError(f"block route {name}: frontier ids "
                                         "differ from the library's")
                if name == "clock64 breakdown" and rnd == 0:
                    lib.clocks_read.argtypes = [ctypes.c_void_p]
                    h = (ctypes.c_ulonglong * 8)()
                    lib.clocks_read(h)            # zero after the timing
                    bench.flush.zero_()
                    fn()
                    torch.cuda.synchronize()
                    lib.clocks_read(h)
                    nb_ = max(h[5], 1)
                    kc = [x / nb_ / 1e3 for x in h[:5]]
                    print(f"[variants] refine_round block route Q={qn} "
                          f"clock64, thousand cycles a block ({h[5]} "
                          f"blocks): expand {kc[0]:.2f}, sort 1 "
                          f"{kc[1]:.2f}, marking {kc[2]:.2f}, compaction "
                          f"{kc[3]:.2f}, rescoring {kc[4]:.2f}, total "
                          f"{sum(kc):.2f}", flush=True)
        del f_in, ids, qh, cand, c_t, o_t
    for label, ms in lines.items():
        print(f"[variants] {label}: " + ", ".join(f"{t:.4f}" for t in ms)
              + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
