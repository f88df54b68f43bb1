#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py [--n-docs N] [--seed S]

Run from the repository root; needs one CUDA device and ``nvcc``. Phases:

1. device: name, count, ``nvidia-smi`` name and power limit; TF32 off for
   float32 matmuls and convolutions, so every reference is full float32;
2. build the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` (one
   ``nvcc`` each, in parallel) and print ptxas' register/spill report,
   and for the redesigned kernels (flash_attention's TMA + wgmma kernel,
   gather_dot_cand, summary_dot's, router_hier's and router_flat's
   bulk-copy kernels, router_flat's groups and bitmap kernels,
   refine_round) one line per variant with registers, static shared
   memory and spills, and the dynamic shared memory each launch requests
   at the main path's shapes;
3. each kernel against its plain PyTorch version at the slices' shapes,
   on seeded inputs: summary_dot (Q = 256, L = 4940, S = 96), gather_dot
   (N = 4096 and 512, nnz = 128) and gather_dot_cand in f32, bf16 and
   u8 values with u16 coords, router_flat (cut 10 over 494 blocks of 96
   entries, one list probed by every query), router_hier (cut 8 over 62
   superblocks of 768 entries, m 32, fanout 8) and refine_round (k 10,
   degree 8, 90 seen ids, repeated ids and duplicate edges, a
   1,048,576-doc forward plane in the three value kinds), d = 30522;
4. run to run: a 65,536-doc collection and its index (superblock fanout
   8) made twice from one seed must be bitwise equal, plane by plane (a
   differing plane is named and fails the run);
5. the collection and the index at the MS MARCO widths of
   ``configs/seismic_msmarco.py`` (d = 30522, 128 nnz per doc, 48 per
   query; lam 6000, beta 400, alpha 0.4, block_cap 64, 96-entry
   summaries, bf16 forward index) with ``CONFIG_HIER``'s superblock tier
   (fanout 8: 62 superblocks of 768 entries per list), ``--n-docs``
   documents (the only cut);
6. the flat path (kernels summary_dot, gather_dot, gather_dot_cand,
   router_flat): ``SeismicServer`` answers 256 queries and
   ``search_pipeline`` a 4096-query batch at fuse levels 0, 1 and 2
   (adaptive policy, cut 10, block_budget 64), with launch counts set to
   0 just before and read just after; the plain path
   (``use_kernel=False``) is the reference at 256; recall@10 against the
   exact top-10 on the card; per-stage times;
7. the kNN graph (``build_doc_graph``, degree 8, 4096 docs per call) and
   the hierarchical, refined path (kernels summary_dot, gather_dot,
   gather_dot_cand, router_hier, refine_round) at ``CONFIG_TUNED``'s
   0.95 operating point (k 10, cut 8, block_budget 128, budget policy,
   superblock_budget 32, graph_degree 8, refine_rounds 2): the same two
   front ends at fuse levels 0, 1 and 2 with launch counts set to 0 just
   before and read just after, the plain reference at 256, recall@10 at
   refine_rounds 0, 1 and 2, per-stage and per-round times;
8. each kernel timed on its main path's own inputs with CUDA events
   (L2 flushed before every launch) beside its bound, the rate it
   reaches on the bytes the bound counts, its plain version and one
   PyTorch library call where one computes the same function; the share
   of summary_dot's, gather_dot_cand's and router_hier's q lookups that
   hit a non-zero of the query (the rest their bitmaps answer);
   router_flat and refine_round also on the 4096-query batch's inputs
   (held against their plain versions 512 queries at a time), with
   router_flat's reuse (live (query, block) rows over the distinct live
   rows) at both batch sizes, and an empty kernel's launch time;
   router_hier at 1, 2, 4 and 8 blocks per query (cluster sizes), at 256
   and 32 queries; then the index and the graph are freed;
9. flash_attention against its plain version on seeded inputs: the
   llama3-8b prefill shape (B 1, Hq 32, Hkv 8, S 8192, D 128, bf16,
   causal), float32 at a ragged S = 200, a window of 64, causal=False,
   D 16 and 64; its time at the prefill shape beside its bound, the
   plain version and ``scaled_dot_product_attention`` (which only this
   script calls), and once at 32768 tokens (prefill_32k of
   ``lm_shapes``) without the plain version;
10. llama3-8b (``configs/llama3_8b.CONFIG``: 32 layers, bf16, drawn on
   the card from the seed) prefills [1, 8192] tokens with the kernel
   (``use_kernel=True``; launch counts set to 0 just before and read
   just after: 32 flash_attention launches) and on the plain chunked
   path; logits compared; two known-wrong attention paths (non-causal,
   a window of half the sequence) must fall outside the logit bound;
   three timed runs;
11. ``LMDecoder(batch=8, max_seq=128)`` answers 8 requests of 32-token
   prompts with 32 greedy tokens each; the decode logits over the
   generated sequences against ``forward(use_kernel=True)``'s;
12. the mutation path (run after phase 8, on phase 7's index and graph):
   ``make_mutable`` lifts it to 1,050,624 docs with a 512-slot tail;
   2,048 docs drawn with another seed are inserted in chunks of 512
   (every chunk after the first compacts first); before the last chunk
   5 % of the base and 10 % of the inserted docs are deleted; a final
   ``compact()``. ``SeismicServer.apply_mutation`` publishes the index to
   the servers of both operating points at fuse 0, 1 and 2 at three
   points (lifted; "during": a full tail and mask-only deletes;
   "after"), and 256 queries (half of them drawn with the inserts' seed)
   go through the 256-query and the online servers, with launch counts
   set to 0 just before and read just after (each of a-f must launch).
   Asserted: bitwise equal across levels and online to batched; the
   kernel path against the plain stages on its route (see
   ``plain_on_kernel_route``); no deleted id returned; recall@10 during
   and after at least 0.98 x a fresh build's (and graph's) of the same
   corpus (the JAX package's mutation gate); the summaries of 64
   compacted lists bound their members; a bitwise ``save_index`` /
   ``load_index`` round trip (under ``build/``) with the same answers;
   every published snapshot on the card. Printed: insert docs/s,
   each compaction's seconds with its minor and major list counts, ms
   per batch lifted / during / after, save and load seconds, peak
   device memory;
13. serving (run after phase 8, before phase 12, on phase 7's index with
   ``TUNED`` attached as a ``TunedPolicy(target=0.95, modeled=True)``):
   at ``TUNED`` and the flat ``SHAPES`` point (fuse 2), 161 requests
   through ``AsyncSeismicServer`` at widths 128, 32 and 8; then 1,024
   requests a point over the 256 queries (each query's first occurrence
   a miss, 32 of them bursts of 4 identical requests, the rest repeats)
   from 4 client threads, Poisson at twice the rate
   ``SeismicServer(max_batch=8)`` sustains one request at a time, through
   ``AsyncSeismicServer(max_batch=128, deadline 2 ms, reject at 4,096,
   cache 4,096, coalescing)`` with ``Observability(stage_sample_every=16)``
   and a ``ShadowAuditor`` per point auditing every 4th launched request:
   ``TUNED``, ``swap_index`` to the flat point (and its auditor) while
   requests are in flight, flat; then ``ReplicaSeismicServer(mirror, 4)``
   at ``TUNED``, and again with replica 0 delayed 5x the median launch.
   Asserted: every request ``done``, bitwise the 256-query server's answer
   at its point (a request submitted after the swap returns only flat
   answers); each kernel's launches exactly the launches times a pipeline
   run's (the swap's warmup runs counted), router_hier's cluster counts
   summing to its launches under 4 replica threads; every trace valid;
   the Prometheus text and one scrape of the exporter equal to the
   registry; audits done, no audit error or drop, the funnel summing to
   the misses, phase 7's offline recall@10 (over the forward plane, the
   auditor's referent) inside the ``TUNED`` audit's 99 % Wilson interval;
   the delayed replica given the smallest dispatch share. Printed:
   request p50/p95/p99 and QPS per server, launches and occupancy per
   width, cache hit rate, coalesced share, dispatch shares,
   staged against fused launch spans, modeled bytes per query and
   achieved GB/s per stage, the audits' recall and interval, seconds and
   peak device memory.

The index and query widths come from ``configs/seismic_msmarco``
(``CONFIG_HIER`` and ``SHAPES``); the 0.95 operating point ``TUNED``
stays a literal until the port has the tuner's sweep.

The last lines are the kernels' JSON record, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero; nothing falls back to the CPU or the plain versions.

Tolerance, retrieval kernel against plain: ``|k - p| <= 2e-5 * |p| +
1e-6``. Every score a kernel returns sums at most 128 nonnegative
float32 products (96-entry summaries, 128-entry forward rows), in
another order than the plain version (the kernel also fuses the
dequant multiply-add); each order is within 128 * 2^-24 ~ 7.6e-6
relative of the exact sum, so two orders differ by less than 1.6e-5.
Integer outputs (router_hier's flat positions, which its 768-entry
stage-A scores choose; refine_round's frontier ids) are equal. Kernel
paths against each other (fuse levels 0, 1, 2): bitwise equal ids,
``docs_evaluated`` and scores, since every retrieval kernel scores a row
with one shared row dot.

flash_attention against plain: float32, ``rtol = atol = 2e-5`` (FMA
dots of at most 128 terms and the online softmax in another order; the
JAX package's own tolerance for its kernel). bf16, element by element,
``|k - p| <= 2**-7 * |p| + 2 * r`` with ``r = 2**-9 * sum_j p_j |v_j| /
sum_j p_j``, the plain version run on ``|v|`` in float32: the kernel
feeds P to P V in bf16, which moves each term ``p_j v_j`` by at most
``2**-9`` of itself, so the output by at most ``r`` (the factor 2 keeps
room for the float32 sums), and both outputs round to bf16, one ulp
apart at most (``2**-7`` relative). ``r`` shrinks with the row's values,
not with the tensor's largest, so a long row that loses one key tile
fails (a planted fault, PERF.md).

llama3-8b logits, two bf16 paths (prefill with the kernel against the
plain path; decode against forward): relative L2 distance at most
``2**-4``. The paths round to bf16 at different places (attention's P,
GEMMs of other shapes); each such rounding moves a value by at most
``2**-9`` relative, and about ten per layer over 32 layers add up as a
random walk to ``sqrt(320) * 2**-9 ~ 3.5 %``; top-1 agreement, the max
abs gap and the plain path's top-1/top-2 logit gap where the argmax
flips are printed beside it. The bound must reject a wrong path: the
prefill with attention called non-causal, or windowed to half the
sequence, is held to it and has to fail (phase 10).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch.configs.seismic_msmarco import CONFIG_HIER, SHAPES
except ModuleNotFoundError as exc:      # the script outside a checkout
    sys.exit(f"chip_smoke: run from a checkout of the repository ({exc})")

RTOL, ATOL = 2e-5, 1e-6
# the slice's shapes: MS MARCO widths (configs/seismic_msmarco.CONFIG_HIER:
# its index config with the superblock tier suggest_fanout picks, fanout 8)
# and the two query batches of its SHAPES; router L = cut * n_blocks
ICFG = CONFIG_HIER.index
DIM, DOC_NNZ, QUERY_NNZ = CONFIG_HIER.dim, CONFIG_HIER.doc_nnz, \
    CONFIG_HIER.query_nnz
_ONLINE, _BATCH = ({c.name: c.dims for c in SHAPES}[n]
                   for n in ("query_online", "query_batch"))
Q_ONLINE, Q_BATCH = _ONLINE["batch"], _BATCH["batch"]
CUT, BLOCK_BUDGET = _ONLINE["cut"], _ONLINE["block_budget"]
# an online server that answers each request as it arrives, one query
# padded to a batch of 8, as the serving benchmark of the JAX package
# (benchmarks/serving_load.py, its closed-loop and replica rows) serves;
# router_hier then runs a cluster of blocks per query
ONLINE_BATCH, ONLINE_REQUESTS = 8, 16
ROUTER_L, SUMMARY_S = CUT * ICFG.n_blocks, ICFG.summary_nnz
SCORER_N, STAGE1_N = 4096, 512
PLANE_DOCS = 1 << 20
# 62 superblocks of 8 * 96 = 768 entries per list
FANOUT, N_SUPER, SUPER_S = (ICFG.superblock_fanout, ICFG.n_superblocks,
                            ICFG.superblock_nnz)
# CONFIG_TUNED's operating point at recall target 0.95 (the JAX
# package's modeled tuning; the port has no tuner yet)
TUNED = dict(k=10, cut=8, block_budget=128, policy="budget",
             superblock_fanout=FANOUT, superblock_budget=32, graph_degree=8,
             refine_rounds=2)
GRAPH_DEGREE, GRAPH_BATCH = 8, 4096
# phase 12: 2,048 docs inserted in chunks of 512 through a tail of 512
# slots (every chunk after the first compacts first); before the last
# chunk 5 % of the base and 10 % of the inserted docs are deleted
MUT_INSERTS, MUT_CHUNK, MUT_TAIL = 2048, 512, 512
MUT_DELETE_BASE, MUT_DELETE_NEW = 0.05, 0.10
RECALL_RATIO = 0.98    # the JAX package's mutation gate (benchmarks/mutation.py)
BOUND_LISTS = 64       # compacted lists whose summaries are checked
SYNTH_LISTS = 2048              # lists of the synthetic router planes
RUN_TO_RUN_DOCS = 1 << 16
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
SOURCES = {
    "summary_dot": ("src/repro_torch/kernels/summary_dot/csrc/summary_dot.cu",
                    "src/repro/kernels/summary_dot/summary_dot.py:72"),
    "gather_dot": ("src/repro_torch/kernels/gather_dot/csrc/gather_dot.cu",
                   "src/repro/kernels/gather_dot/gather_dot.py:91"),
    "gather_dot_cand": (
        "src/repro_torch/kernels/gather_dot/csrc/gather_dot.cu",
        "src/repro/kernels/gather_dot/gather_dot.py:202"),
    "router_flat": (
        "src/repro_torch/kernels/router_fused/csrc/router_fused.cu",
        "src/repro/kernels/router_fused/router_fused.py:96"),
    "router_hier": (
        "src/repro_torch/kernels/router_fused/csrc/router_fused.cu",
        "src/repro/kernels/router_fused/router_fused.py:186"),
    "refine_round": (
        "src/repro_torch/kernels/refine_fused/csrc/refine_fused.cu",
        "src/repro/kernels/refine_fused/refine_fused.py:118"),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:84"),
}
RETRIEVAL = tuple(n for n in SOURCES if n != "flash_attention")
# the LM slice: llama3-8b (configs/llama3_8b.py) at full width and depth;
# prefill at 8192 tokens and once at prefill_32k's 32768 (lm_shapes),
# serving 8 requests of 32-token prompts with 32 new tokens each
LM_SEQ, LM_LONG_SEQ = 8192, 32768
SERVE_BATCH, SERVE_MAX_SEQ, PROMPT_LEN, NEW_TOKENS = 8, 128, 32, 32
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
# phase 13: 1,024 requests a point over the 256 queries from 4 client
# threads (Poisson arrivals at twice the rate SeismicServer(max_batch=8)
# sustains one request at a time, as benchmarks/serving_load.py offers
# it); 32 first occurrences come as bursts of 4 identical requests
SERVE_REQUESTS, SERVE_BURSTS, SERVE_CLIENTS = 1024, 32, 4
SERVE_MAX_BATCH, SERVE_DEADLINE = 128, 2e-3    # ladder 8 / 32 / 128
SERVE_QUEUE = SERVE_CACHE = 4096
STAGE_SAMPLE, AUDIT_EVERY = 16, 4   # staged launch, audited request
# the audits' Wilson intervals at 99 %: about 64 of the 256 queries are
# audited, chosen by the batching, and misses cluster by query, so a
# 95 % interval would miss phase 7's recall over all 256 in several runs
# of 100 with a correct server
AUDIT_Z = 2.576
REPLICAS, DELAY_FACTOR = 4, 5       # the delayed replica: 5x median launch
SYNC_REQUESTS = 64                  # to time the one-at-a-time server
SERVE_TIMEOUT = 120.0
ATTN_F32_TOL = 2e-5            # flash_attention, float32: rtol = atol
LM_REL_L2 = 2 ** -4            # llama3-8b logits, two bf16 paths


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Bench:
    """CUDA-event timing of one callable, L2 flushed before each launch."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def ptxas_lines(report: str) -> list[str]:
    """One line per variant of the redesigned kernels (flash_attention's
    TMA + wgmma kernel, gather_dot_cand's, summary_dot's, router_hier's,
    router_flat's three and refine_round's kernels) from ptxas' report:
    registers at launch, static shared memory, spill stores and loads."""
    lines, name, info = [], None, {}
    types = {"i": "int32", "t": "uint16", "f": "f32", "h": "u8",
             "13__nv_bfloat16": "bf16"}
    for line in report.splitlines() + ["Compiling entry function 'end'"]:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            if name and info:
                lines.append(f"{name}: {info.get('regs', '?')} registers, "
                             f"{info.get('smem', 0)} B static shared "
                             f"memory, spill stores {info.get('st', '?')} B, "
                             f"loads {info.get('ld', '?')} B")
            mangled, name, info = m.group(1), None, {}
            fa = re.search(r"fa_wgmma_kernelILi(\d+)E", mangled)
            cand = re.search(r"gather_dot_cand_kernelI(i|t)"
                             r"(f|h|13__nv_bfloat16)Lb\dE", mangled)
            summ = re.search(r"summary_dot_kernelILi(\d+)ELi(\d+)E", mangled)
            hier = re.search(r"router_hier_kernelILi(\d+)ELi(\d+)ELi(\d+)"
                             r"ELi(\d+)E", mangled)
            flat = re.search(r"router_flat_kernelILi(\d+)ELi(\d+)E", mangled)
            helper = re.search(r"router_flat_(groups|records)_kernel",
                               mangled)
            refine = re.search(r"refine_round_kernelILi(\d+)E(i|t)"
                               r"(f|h|13__nv_bfloat16)Lb\dE", mangled)
            if fa:
                name = f"fa_wgmma_kernel<D {fa.group(1)}>"
            elif cand:
                name = (f"gather_dot_cand_kernel<{types[cand.group(1)]} "
                        f"coords, {types[cand.group(2)]} values>")
            elif summ:
                name = (f"summary_dot_kernel<{summ.group(1)} rows per warp, "
                        f"{summ.group(2)} entries per lane ahead>")
            elif hier:
                name = (f"router_hier_kernel<stage A {hier.group(1)} rows "
                        f"per warp, {hier.group(2)} entries ahead; stage B "
                        f"{hier.group(3)} rows, {hier.group(4)} entries>")
            elif flat:
                name = (f"router_flat_kernel<{flat.group(1)} rows per warp, "
                        f"{flat.group(2)} entries per lane ahead>")
            elif helper:
                name = f"router_flat_{helper.group(1)}_kernel"
            elif refine:
                name = (f"refine_round_kernel<{refine.group(1)} ids a lane, "
                        f"{types[refine.group(2)]} coords, "
                        f"{types[refine.group(3)]} values>")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            info["st"], info["ld"] = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info["regs"] = m.group(1)
            sm = re.search(r"(\d+) bytes smem", line)
            info["smem"] = sm.group(1) if sm else 0
    return lines


def compare(torch, name, got, want) -> tuple[float, float]:
    """Max abs and max rel error of a kernel against its plain version;
    raises beyond the stated tolerance or on differing -inf positions."""
    torch.cuda.synchronize()
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        raise AssertionError(f"{name}: -inf positions differ")
    fin = torch.isfinite(want)
    g, w = got[fin].double(), want[fin].double()
    err = (g - w).abs()
    abs_err = float(err.max()) if err.numel() else 0.0
    rel_err = float((err / w.abs().clamp_min(1e-30)).max()) \
        if err.numel() else 0.0
    beyond = int((err > RTOL * w.abs() + ATOL).sum())
    if beyond:
        raise AssertionError(f"{name}: max abs err {abs_err:.3e}, max rel "
                             f"err {rel_err:.3e}; {beyond} of {err.numel()} "
                             f"finite elements beyond rtol={RTOL} "
                             f"atol={ATOL}")
    return abs_err, rel_err


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def synthetic_phase(torch, dev, gen) -> None:
    """Phase 3, the unfused kernels: every variant of summary_dot,
    gather_dot and gather_dot_cand against its plain version at the
    slice's shapes, on seeded random inputs."""
    from repro_torch.kernels.gather_dot.ops import (
        gather_dot_batch, gather_dot_batch_ref, gather_dot_cand_batch,
        gather_dot_cand_ref)
    from repro_torch.kernels.summary_dot.ops import (summary_dot_batch,
                                                     summary_dot_batch_ref)
    from repro_torch.sparse.quant import quantize_u8
    d, qn, nnz = DIM, Q_ONLINE, DOC_NNZ
    ln, s, n_docs = ROUTER_L, SUMMARY_S, PLANE_DOCS

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    q = rand(qn, d) * (rand(qn, d) < QUERY_NNZ / d)      # ~48 nnz per query
    q[:, 0] = 1.0
    levels = ints(256, qn, ln, s).to(torch.uint8)
    levels[0, :ln // 5] = 0                               # all-padding rows
    args = (q, ints(d, qn, ln, s), levels, rand(qn, ln) * 0.01, rand(qn, ln))
    e = compare(torch, "summary_dot", summary_dot_batch(*args),
                summary_dot_batch_ref(*args))
    log(f"  summary_dot  Q={qn} L={ln} S={s}: max abs {e[0]:.3e} "
        f"rel {e[1]:.3e}")
    # the superblock tier's shape (the long-row variant), from a generator
    # of its own so the other checks keep their inputs
    g2 = torch.Generator(device=dev).manual_seed(gen.initial_seed() + 1)
    ls, s2 = TUNED["cut"] * N_SUPER, SUPER_S
    lv = torch.randint(0, 256, (qn, ls, s2), generator=g2, device=dev,
                       dtype=torch.int32).to(torch.uint8)
    lv[0, :ls // 5] = 0                                   # all-padding rows
    lv[1:, ls - 3:] = 0
    sargs = (q, torch.randint(0, d, (qn, ls, s2), generator=g2, device=dev,
                              dtype=torch.int32), lv,
             torch.rand((qn, ls), generator=g2, device=dev) * 0.01,
             torch.rand((qn, ls), generator=g2, device=dev))
    e = compare(torch, "summary_dot superblock tier",
                summary_dot_batch(*sargs), summary_dot_batch_ref(*sargs))
    log(f"  summary_dot  Q={qn} L={ls} S={s2}: max abs {e[0]:.3e} "
        f"rel {e[1]:.3e}")

    def planes(shape, kind):
        coords = ints(d, *shape)
        vals = rand(*shape) * (rand(*shape) < 0.9)
        if kind == "u8":
            u8, scale, zero = quantize_u8(vals)
            return coords.to(torch.int16).view(torch.uint16), u8, scale, zero
        return coords, vals.to(getattr(torch, kind)), None, None

    for kind in ("float32", "bfloat16", "u8"):
        for n in (SCORER_N, STAGE1_N):
            rows = planes((qn, n, nnz), kind)
            e = compare(torch, f"gather_dot {kind}",
                        gather_dot_batch(q, *rows),
                        gather_dot_batch_ref(q, *rows))
            log(f"  gather_dot   {kind:8s} N={n}: max abs {e[0]:.3e} "
                f"rel {e[1]:.3e}")
        plane = planes((n_docs, nnz), kind)
        c = SCORER_N
        live = torch.randint(0, c + 1, (qn,), generator=gen, device=dev)
        live[::7] = 0                                     # all-sentinel rows
        ids = torch.sort(ints(n_docs, qn, c), dim=1).values
        cand = torch.where(torch.arange(c, device=dev) < live[:, None],
                           ids, n_docs).to(torch.int32)
        e = compare(torch, f"gather_dot_cand {kind}",
                    gather_dot_cand_batch(q, cand, *plane, n_docs=n_docs),
                    gather_dot_cand_ref(q, cand, *plane, n_docs))
        log(f"  gather_dot_cand {kind:8s} C={c}: max abs {e[0]:.3e} "
            f"rel {e[1]:.3e}")


def fused_synthetic_phase(torch, dev, gen) -> None:
    """Phase 3, the fused kernels: router_flat, router_hier and
    refine_round against their plain versions on seeded inputs."""
    from repro_torch.kernels.refine_fused.ops import (refine_round_batch,
                                                      refine_round_ref)
    from repro_torch.kernels.router_fused.ops import (router_flat_batch,
                                                      router_flat_ref,
                                                      router_hier_batch,
                                                      router_hier_ref)
    from repro_torch.sparse.quant import quantize_u8
    d, qn, nl, nb, s = DIM, Q_ONLINE, SYNTH_LISTS, ROUTER_L // CUT, SUMMARY_S

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def tier(n, width):
        vals = rand(nl, n, width) * (rand(nl, n, width) < 0.9)
        return (ints(0, d, nl, n, width),) + quantize_u8(vals)

    q = rand(qn, d) * (rand(qn, d) < QUERY_NNZ / d)
    q[:, 0] = 1.0
    block_len = ints(0, 3, nl, nb)                   # a third of blocks dead
    block_len[0] = 0                                 # a dead list
    blocks = tier(nb, s)
    lists = ints(0, nl, qn, CUT)
    lists[0] = 0
    lists[:, 1] = 1                 # probed by every query: 32 full groups
    args = (lists, q) + blocks + (block_len,)
    e = compare(torch, "router_flat", router_flat_batch(*args),
                router_flat_ref(*args))
    log(f"  router_flat  Q={qn} cut={CUT} nb={nb} S={s}: max abs "
        f"{e[0]:.3e} rel {e[1]:.3e}")
    lists8 = lists[:, :TUNED["cut"]].contiguous()
    hargs = (lists8, q) + tier(N_SUPER, SUPER_S) + blocks + (block_len,)
    m = TUNED["superblock_budget"]
    rb, flat = router_hier_batch(*hargs, m=m, fanout=FANOUT)
    want_rb, want_flat = router_hier_ref(*hargs, m=m, fanout=FANOUT)
    if not torch.equal(flat, want_flat):
        diff = flat != want_flat
        raise AssertionError(
            f"router_hier: flat positions differ from the plain version at "
            f"{int(diff.sum())} of {diff.numel()} positions in "
            f"{int(diff.any(1).sum())} of {qn} queries")
    e = compare(torch, "router_hier", rb, want_rb)
    log(f"  router_hier  Q={qn} cut={TUNED['cut']} ns={N_SUPER} "
        f"S2={SUPER_S} m={m} f={FANOUT}: flat positions equal, max abs "
        f"{e[0]:.3e} rel {e[1]:.3e}")
    k, degree, n_docs, nnz = TUNED["k"], TUNED["graph_degree"], PLANE_DOCS, \
        DOC_NNZ
    knn = ints(0, n_docs, n_docs, degree)
    knn[rand(n_docs, degree) < 0.05] = n_docs        # missing edges
    ids = ints(0, n_docs, qn, k)
    ids[::5, k // 2:] = -1
    ids[1::3, 1] = ids[1::3, 0]      # repeated ids: duplicate neighbours
    knn[::2, 1] = knn[::2, 0]        # and duplicate edges
    w = k + k * degree               # the seen set of a second round
    scored = torch.cat([torch.where(ids >= 0, ids, n_docs),
                        knn[ids[:, :1].long().clamp(min=0)].reshape(qn, -1),
                        ints(0, n_docs, qn, w - k - degree)], dim=1)
    for kind in ("float32", "bfloat16", "u8"):
        coords = ints(0, d, n_docs, nnz)
        vals = rand(n_docs, nnz) * (rand(n_docs, nnz) < 0.9)
        if kind == "u8":
            plane = (coords.to(torch.int16).view(torch.uint16),) \
                + quantize_u8(vals)
        else:
            plane = (coords, vals.to(getattr(torch, kind)), None, None)
        fargs = (ids, scored.contiguous(), q, knn) + plane
        cand, scores = refine_round_batch(*fargs, n_docs=n_docs,
                                          degree=degree)
        want_c, want_s = refine_round_ref(*fargs, n_docs, degree)
        if not torch.equal(cand, want_c):
            raise AssertionError(f"refine_round {kind}: frontier ids differ "
                                 "from the plain version")
        e = compare(torch, f"refine_round {kind}", scores, want_s)
        log(f"  refine_round {kind:8s} k={k} degree={degree} W={w}: "
            f"frontier ids equal ({int((cand < n_docs).sum())} live), max "
            f"abs {e[0]:.3e} rel {e[1]:.3e}")


def run_to_run_phase(torch, dev, seed) -> None:
    """Phase 4: the collection and the index made twice from one seed at
    65,536 docs; raises naming every plane that differs."""
    from repro_torch.core.build import build_index
    from repro_torch.data import SyntheticSparseConfig, make_collection
    cfg = SyntheticSparseConfig(dim=DIM, n_docs=RUN_TO_RUN_DOCS,
                                n_queries=Q_ONLINE, doc_nnz=DOC_NNZ,
                                query_nnz=QUERY_NNZ, seed=seed)
    (d1, q1, _), (d2, q2, _) = (make_collection(cfg, device=dev)
                                for _ in range(2))
    icfg = dataclasses.replace(ICFG, seed=seed)
    i1, i2 = build_index(d1, icfg), build_index(d1, icfg)
    index_planes = [("fwd.coords", i1.fwd.coords, i2.fwd.coords),
                    ("fwd.vals", i1.fwd.vals, i2.fwd.vals)]
    index_planes += [(n, t, getattr(i2, n))
                     for n, t in i1._tensor_fields().items() if t is not None]
    for what, planes in (
            ("collection", [("docs.coords", d1.coords, d2.coords),
                            ("docs.vals", d1.vals, d2.vals),
                            ("queries.coords", q1.coords, q2.coords),
                            ("queries.vals", q1.vals, q2.vals)]),
            ("index from one collection", index_planes)):
        differ = [f"{n} ({int((a != b).sum())} entries)" for n, a, b in planes
                  if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"run to run, {what}: {', '.join(differ)} "
                                 "differ")
        log(f"  {what} twice: all {len(planes)} planes bitwise equal")


def same_results(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def as_triple(out):
    """(scores, ids, docs_evaluated) of a server result or a pipeline
    tuple."""
    if isinstance(out, tuple):
        return out
    return out.scores, out.ids, out.docs_evaluated


def check_against_plain(torch, label, got, ref, k) -> int:
    """Kernel path against the plain path: scores within tolerance, ids
    equal except at non-isolated scores (or the k-th position). Returns
    the number of rows whose ids differ."""
    compare(torch, f"{label} scores vs plain", got[0], ref[0])
    diff = got[1] != ref[1]
    for q, i in diff.nonzero().tolist():
        s = ref[0][q].double()
        near = (s - s[i]).abs() <= ATOL + RTOL * abs(float(s[i]))
        if int(near.sum()) < 2 and i != k - 1:
            raise AssertionError(f"{label}: query {q} ids differ from the "
                                 "plain path at an isolated score")
    return int(diff.any(dim=1).sum())


ONLINE = f"online {ONLINE_BATCH}"
LABELS = ("server 256", ONLINE, "pipeline 4096")


def front_ends(SeismicServer, index, levels, telemetry=None) -> dict:
    """Each level's 256-query server (with a ``telemetry()`` of its own
    when given) and online server (batches of ONLINE_BATCH), keyed by
    level."""
    return {f: (SeismicServer(index, p, max_batch=Q_ONLINE,
                              telemetry=telemetry and telemetry()),
                SeismicServer(index, p, max_batch=ONLINE_BATCH))
            for f, p in levels.items()}


def drive(torch, servers, search_pipeline, q256, q4096=None):
    """Every level's server (256 queries), online server (ONLINE_REQUESTS
    requests of one query each) and, with ``q4096``, pipeline (4096 on the
    server's index) run three times each -> (last results, ms per run),
    keyed (level, label)."""
    results, batch_ms = {}, {}
    for fuse, (server, online) in servers.items():
        def per_request():
            outs = [online.search(q256[i:i + 1])
                    for i in range(ONLINE_REQUESTS)]
            return tuple(torch.cat(parts) for parts in
                         zip(*map(as_triple, outs)))
        runs = [("server 256", lambda: server.search(q256)),
                (ONLINE, per_request)]
        if q4096 is not None:
            runs.append(("pipeline 4096", lambda: search_pipeline(
                server.index, q4096, server.params)))
        for label, run in runs:
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            results[fuse, label] = as_triple(out)
            batch_ms[fuse, label] = times
    return results, batch_ms


def check_levels(torch, name, results, batch_ms, levels,
                 labels=LABELS) -> None:
    """Ids, docs_evaluated and scores bitwise equal across the levels, and
    the online server's answers bitwise the 256-query server's."""
    for label in labels:
        base = results[0, label]
        for fuse in levels:
            if not same_results(torch, results[fuse, label], base):
                raise AssertionError(
                    f"{name} {label}: ids, docs_evaluated or scores differ "
                    f"between fuse levels 0 and {fuse}")
        times = "; ".join(
            f"fuse {f} ms {['%.1f' % t for t in batch_ms[f, label]]}"
            for f in levels)
        log(f"  {name} {label}: {times}"
            + f"; ids, docs_evaluated and scores bitwise equal across levels;"
            f" mean docs_evaluated {float(base[2].float().mean()):.1f}")
    batched = [x[:ONLINE_REQUESTS] for x in results[0, "server 256"]]
    if not same_results(torch, results[0, ONLINE], batched):
        raise AssertionError(f"{name}: the online server's answers differ "
                             "from the 256-query server's")
    log(f"  {name} {ONLINE}: the {ONLINE_REQUESTS} answers bitwise equal "
        "to the 256-query server's")


def staged_ms(index, p, qs, run_pipeline_staged, split_refine=False) -> str:
    stages: dict[str, float] = {}
    for _ in range(2):
        run_pipeline_staged(index, qs.coords, qs.vals, p,
                            record=stages.__setitem__,
                            split_refine=split_refine)
    return ", ".join(f"{k} {v * 1e3:.2f}" for k, v in stages.items())


def compare_attention(torch, name, got, want,
                      row=None) -> tuple[float, float]:
    """flash_attention against its plain version -> (max abs error, the
    worst element's share of its tolerance); raises beyond the stated
    tolerance (float32: rtol = atol = 2e-5; bf16: ``2**-7 * |p| + 2 *
    2**-9 * row``, ``row`` the plain version on ``|v|`` in float32)."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if got.dtype == torch.float32:
        tol = ATTN_F32_TOL * w.abs() + ATTN_F32_TOL
    else:
        tol = 2 ** -7 * w.abs() + 2 * 2 ** -9 * row
    worst = float((err / tol.clamp_min(1e-30)).max())
    if bool((err > tol).any()) or not bool(torch.isfinite(g).all()):
        bad = (err > tol).any(-1).nonzero()[:, 2]   # q positions
        raise AssertionError(
            f"{name}: {bad.numel()} rows beyond tolerance, q positions "
            f"{int(bad.min()) if bad.numel() else '-'} to "
            f"{int(bad.max()) if bad.numel() else '-'} (worst element at "
            f"{worst:.2f}x it); max abs err {float(err.max()):.3e}, max|p| "
            f"{float(w.abs().max()):.3e}")
    return float(err.max()), worst


def attention_inputs(torch, dev, gen, b, hq, hkv, s, d, dtype):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    return randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d)


def flash_check(torch, dev, gen) -> float:
    """Phase 9, the check: flash_attention against its plain version on
    seeded inputs -> max abs error at the model's shape."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_ref)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # label, B, Hq, Hkv, S, D, dtype, causal, window
        ("llama3-8b prefill", 1, 32, 8, LM_SEQ, 128, bf16, True, None),
        ("f32 ragged", 2, 4, 2, 200, 128, f32, True, None),
        ("window 64", 1, 8, 2, 1000, 128, bf16, True, 64),
        ("non-causal", 1, 8, 2, 1000, 128, bf16, False, None),
        ("D 16", 2, 4, 1, 333, 16, bf16, True, None),
        ("D 64", 2, 8, 2, 333, 64, bf16, True, None),
    ]
    model_err = None
    for label, b, hq, hkv, s, d, dt, causal, window in cases:
        q, k, v = attention_inputs(torch, dev, gen, b, hq, hkv, s, d, dt)
        got = flash_attention(q, k, v, causal=causal, window=window)
        err = worst = 0.0
        g = hq // hkv
        for h0 in range(0, hq, 8):   # the plain scores, 8 heads at a time
            h1 = min(h0 + 8, hq)
            kh, vh = (x[:, h0 // g:(h1 - 1) // g + 1] for x in (k, v))
            qh = q[:, h0:h1]
            want = flash_attention_ref(qh, kh, vh, causal=causal,
                                       window=window)
            row = None if dt == f32 else flash_attention_ref(
                qh.float(), kh.float(), vh.float().abs(), causal=causal,
                window=window)
            e, w = compare_attention(
                torch, f"flash_attention {label} (max|v| "
                f"{float(vh.float().abs().max()):.3f})", got[:, h0:h1], want,
                row)
            err, worst = max(err, e), max(worst, w)
            del want, row
        model_err = err if model_err is None else model_err
        log(f"  flash_attention {label}: B={b} Hq={hq} Hkv={hkv} S={s} D={d} "
            f"{str(dt).split('.')[1]} causal={causal} window={window}: max "
            f"abs err {err:.3e}, worst element at {worst:.3f} of its "
            "tolerance")
    return model_err


def flash_phase(torch, dev, gen, bench) -> dict:
    """Phase 9: flash_attention against its plain version (``flash_check``),
    then its times at the prefill's shape (and once at 32768 tokens)
    beside its bound, the plain version and
    ``scaled_dot_product_attention``, which only this script calls."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_ref)
    bf16 = torch.bfloat16
    model_err = flash_check(torch, dev, gen)
    b, hq, hkv, s, d = 1, 32, 8, LM_SEQ, 128
    q, k, v = attention_inputs(torch, dev, gen, b, hq, hkv, s, d, bf16)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def row(s, q, k, v, plain: bool):
        kern = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
        lib = lambda: sdpa(q, k, v, is_causal=True,           # noqa: E731
                           enable_gqa=True)
        iters = 10 if s == LM_SEQ else 3
        ms, lib_ms = bench.ms(kern, iters=iters), bench.ms(lib, iters=iters)
        plain_ms = bench.ms(lambda: flash_attention_ref(q, k, v, causal=True),
                            iters=2, warmup=1) if plain else None
        gap = float((kern().float() - lib().float()).abs().max())
        pairs = s * (s + 1) // 2                 # causal (q, k) pairs
        ops = 4 * d * hq * b * pairs             # Q K^T and P V
        nbytes = 2 * b * s * d * 2 * (hq + hkv)  # q, o, k, v in bf16
        t_ops, t_bytes = ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        bms = max(t_ops, t_bytes) * 1e3
        by = "operations" if t_ops >= t_bytes else "bytes"
        log(f"[9 flash_attention] [{b}, {hq}, {s}, {d}] bf16 causal, Hkv "
            f"{hkv}: {ms:.4f} ms (bound {bms:.4f} ms by {by}: "
            f"{ops / 1e12:.3f} TFLOP at 989 TFLOP/s, {nbytes / 1e6:.1f} MB "
            f"at 3.35 TB/s; {bms / ms:.1%} of it, {ops / ms / 1e9:.1f} "
            f"TFLOP/s), plain "
            f"{'not timed' if plain_ms is None else f'{plain_ms:.3f} ms'}, "
            f"scaled_dot_product_attention {lib_ms:.4f} ms (max abs gap to "
            f"the kernel {gap:.3e})")
        return ms, plain_ms, bms, by, lib_ms

    ms, plain_ms, bms, by, lib_ms = row(s, q, k, v, plain=True)
    del q, k, v
    torch.cuda.empty_cache()
    s_long = LM_LONG_SEQ
    row(s_long, *attention_inputs(torch, dev, gen, b, hq, hkv, s_long, d,
                                  bf16), plain=False)
    src, rep = SOURCES["flash_attention"]
    return dict(name="flash_attention", route="cuda", source=src,
                replaces=rep, launches=None, max_abs_err=model_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)


def logit_distance(torch, label, got, want) -> tuple[float, str]:
    """Two bf16 paths' logits: finite and of one shape -> (relative L2
    distance, text with the max abs gap, the top-1 agreement and the
    ``want`` path's top-1/top-2 gap where the argmax flips)."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shapes {tuple(got.shape)} and "
                             f"{tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not (bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all())):
        raise AssertionError(f"{label}: non-finite logits")
    rel = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
    flip = g.argmax(-1) != w.argmax(-1)
    top2 = w.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    at_flip = (f"median {float(gap[flip].median()):.4f}, max "
               f"{float(gap[flip].max()):.4f}" if bool(flip.any())
               else "no flips")
    text = (f"relative L2 {rel:.3e}, max abs {float((g - w).abs().max()):.3e}"
            f" (logits' max abs {float(w.abs().max()):.2f}), top-1 "
            f"agreement {1 - float(flip.float().mean()):.4f}; top-1/top-2 "
            f"gap of the reference where the argmax flips: {at_flip} "
            f"(median over all positions {float(gap.median()):.4f})")
    return rel, text


def lm_agreement(torch, label, got, want) -> str:
    """``logit_distance``'s text; raises beyond LM_REL_L2."""
    rel, text = logit_distance(torch, label, got, want)
    if rel > LM_REL_L2:
        raise AssertionError(f"{label}: {text}; beyond {LM_REL_L2}")
    return text


@contextlib.contextmanager
def wrong_attention(attention, **override):
    """The model's flash_attention calls take ``override`` inside: a
    known-wrong path for the logit bound to reject."""
    kernel = attention.flash_attention
    attention.flash_attention = lambda q, k, v, **kw: kernel(
        q, k, v, **{**kw, **override})
    try:
        yield
    finally:
        attention.flash_attention = kernel


def lm_phases(torch, dev, seed, runtime) -> dict:
    """Phases 9-11: flash_attention against plain and timed; llama3-8b
    prefill at [1, 8192] with the kernel against the plain chunked path;
    ``LMDecoder`` serving 8 requests, its decode logits against the
    forward's. Returns flash_attention's record."""
    from repro_torch.configs import llama3_8b
    from repro_torch.models.transformer import attention, lm
    from repro_torch.serve import LMDecoder
    t_lm = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    bench = Bench(torch, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    rec = flash_phase(torch, dev, gen, bench)
    log(f"  phase 9 in {time.perf_counter() - t_lm:.1f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    del bench
    torch.cuda.empty_cache()

    # ---- 10. llama3-8b prefill, kernel path against the plain path
    cfg = llama3_8b.CONFIG
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    n_norm = sum(p.numel() for p in params.parameters()
                 if p.dtype == torch.float32)
    log(f"[10 llama3-8b prefill] {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads ({cfg.n_kv_heads} kv) of "
        f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}: "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s; "
        f"{cfg.param_count()} parameters, {nbytes} bytes ({n_norm} float32 "
        f"norm gains as in the JAX package; {2 * cfg.param_count()} at 2 "
        f"bytes each)")
    tokens = torch.randint(0, cfg.vocab, (1, LM_SEQ), generator=gen,
                           device=dev)
    torch.cuda.synchronize()
    runtime.reset_launches()
    logits_k, _ = lm.forward(params, tokens, cfg, use_kernel=True)
    torch.cuda.synchronize()
    prefill_launches = dict(runtime.LAUNCHES)
    log(f"  launches of one forward [1, {LM_SEQ}], use_kernel=True: "
        f"{prefill_launches}")
    if prefill_launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"flash_attention launched "
                             f"{prefill_launches['flash_attention']} times "
                             f"in one forward, not {cfg.n_layers}")
    rec["launches"] = prefill_launches["flash_attention"]
    t0 = time.perf_counter()
    logits_p, _ = lm.forward(params, tokens, cfg, use_kernel=False)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    log(f"  logits {tuple(logits_k.shape)} {logits_k.dtype}, kernel path vs "
        f"plain path ({plain_s:.2f} s): "
        + lm_agreement(torch, "prefill kernel vs plain", logits_k, logits_p))
    del logits_k
    # the bound must reject a wrong path: attention non-causal, or
    # windowed to half the sequence
    for label, override in (("non-causal", dict(causal=False)),
                            (f"window {LM_SEQ // 2}",
                             dict(window=LM_SEQ // 2))):
        with wrong_attention(attention, **override):
            logits_w, _ = lm.forward(params, tokens, cfg, use_kernel=True)
        rel, text = logit_distance(torch, label, logits_w, logits_p)
        del logits_w
        log(f"  known-wrong path, attention {label}, vs plain path: {text}")
        if rel <= LM_REL_L2:
            raise AssertionError(f"the logit bound {LM_REL_L2} does not "
                                 f"reject attention {label}")
    del logits_p
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        lm.forward(params, tokens, cfg, use_kernel=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"  prefill [1, {LM_SEQ}], use_kernel=True, 3 runs: "
        + ", ".join(f"{t:.1f} ms ({LM_SEQ / t * 1e3:.0f} tokens/s)"
                    for t in times)
        + f"; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    # ---- 11. serving: LMDecoder, greedy; decode logits against forward
    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, PROMPT_LEN),
                            generator=gen, device=dev)
    steps = PROMPT_LEN + NEW_TOKENS
    dec = LMDecoder(params, cfg, batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ)
    runtime.reset_launches()
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        toks = dec.generate(prompts, NEW_TOKENS)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    serve_launches = dict(runtime.LAUNCHES)
    log(f"[11 serving] LMDecoder(batch={SERVE_BATCH}, max_seq="
        f"{SERVE_MAX_SEQ}): {SERVE_BATCH} requests of {PROMPT_LEN}-token "
        f"prompts, {NEW_TOKENS} greedy tokens each ({steps} decode steps, "
        f"prefill by stepping): " + ", ".join(
            f"{r:.0f} ms ({r / steps:.2f} ms per decode step)" for r in runs)
        + f"; kernel launches {sum(serve_launches.values())} (decode "
        "attention is plain, as in the JAX package)")
    if toks.shape != (SERVE_BATCH, steps) or not bool(
            torch.equal(toks[:, :PROMPT_LEN], prompts.to(torch.int32))):
        raise AssertionError("LMDecoder: tokens of the wrong shape or "
                             "prompts not kept")
    cache = lm.init_cache(cfg, SERVE_BATCH, SERVE_MAX_SEQ, device=dev)
    dec_logits = torch.stack(
        [lm.decode_step(params, cache, toks[:, i:i + 1], i, cfg)[0]
         for i in range(steps)], dim=1)
    fwd, _ = lm.forward(params, toks, cfg, use_kernel=True)
    chosen = dec_logits[:, PROMPT_LEN - 1:-1].argmax(-1)
    greedy = toks[:, PROMPT_LEN:] == chosen
    log(f"  decode logits [{SERVE_BATCH}, {steps}, V] vs forward(use_kernel="
        "True) over the generated sequences: "
        + lm_agreement(torch, "decode vs forward", dec_logits, fwd)
        + f"; generated tokens equal to the argmax of the decode logits: "
        f"{float(greedy.float().mean()):.4f}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    log(f"  LM phases 9-11 in {time.perf_counter() - t_lm:.1f} s")
    return rec


def retrieval_phases(torch, dev, args, runtime) -> tuple[list, dict]:
    """Phases 5-8 (the index, the flat and the hierarchical, refined
    paths, kernels a-f timed) -> (the six retrieval kernels' records,
    phase 7's index with its graph, the 256 queries and the offline
    recall@10 of phases 6 and 7, for phases 13 and 12)."""
    from repro_torch.core.build import build_index, live_blocks, \
        suggest_fanout
    from repro_torch.core.oracle import exact_topk, mean_recall_at_k
    from repro_torch.data import SyntheticSparseConfig, make_collection
    from repro_torch.graph import build_doc_graph
    from repro_torch.graph.refine import scored_init
    from repro_torch.kernels.gather_dot.ops import (
        cand_tiles_processed, gather_dot_batch, gather_dot_batch_ref,
        gather_dot_cand_batch, gather_dot_cand_ref)
    from repro_torch.kernels.refine_fused.ops import (empty_launch,
                                                      refine_round_batch,
                                                      refine_round_ref)
    from repro_torch.kernels import row_tiles
    from repro_torch.kernels.router_fused.ops import (CLUSTER_LAUNCHES,
                                                      router_flat_batch,
                                                      router_flat_ref,
                                                      router_hier_batch,
                                                      router_hier_ref)
    from repro_torch.kernels.summary_dot.ops import (summary_dot_batch,
                                                     summary_dot_batch_ref)
    from repro_torch.retrieval import (SearchParams, run_pipeline_staged,
                                       search_pipeline)
    from repro_torch.retrieval.prep import prep_queries
    from repro_torch.serve import SeismicServer
    from repro_torch.sparse.ops import take_rows
    from repro_torch.sparse.quant import dequantize_u8

    # ---- 5. collection and index at the MS MARCO widths, superblock tier
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    data_cfg = SyntheticSparseConfig(dim=DIM, n_docs=args.n_docs,
                                     n_queries=Q_BATCH, doc_nnz=DOC_NNZ,
                                     query_nnz=QUERY_NNZ, seed=args.seed)
    docs, queries, _ = make_collection(data_cfg, device=dev)
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    icfg = dataclasses.replace(ICFG, seed=args.seed)
    timings: dict[str, float] = {}
    t0 = time.perf_counter()
    index = build_index(docs, icfg, timings=timings)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    log(f"[5 index] {args.n_docs} docs (MS MARCO: 8841823), d={DIM}, "
        f"collection {t_data:.1f} s, build {t_build:.1f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in timings.items()))
    log(f"  index bytes {json.dumps(index.nbytes())}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
        f"n_blocks {icfg.n_blocks}, n_superblocks {icfg.n_superblocks} of "
        f"{index.sup_coords.shape[-1]} entries; live blocks "
        f"{int((index.block_len > 0).sum())}; suggest_fanout of the live "
        f"blocks {suggest_fanout(live_blocks(index))} (configured "
        f"{FANOUT})")

    # ---- 6. the flat path
    q256, q4096 = queries[:Q_ONLINE], queries
    base = dict(k=10, cut=CUT, block_budget=BLOCK_BUDGET)
    plain = SearchParams(use_kernel=False, fuse_level=0, **base)
    ref256 = search_pipeline(index, q256, plain)
    levels = {f: SearchParams(use_kernel=True, fuse_level=f, **base)
              for f in (0, 1, 2)}
    torch.cuda.synchronize()
    runtime.reset_launches()
    results, batch_ms = drive(torch, front_ends(SeismicServer, index, levels),
                              search_pipeline, q256, q4096)
    flat_launches = dict(runtime.LAUNCHES)
    log(f"[6 flat path] launches {flat_launches}")
    for name in ("summary_dot", "gather_dot", "gather_dot_cand",
                 "router_flat", "router_flat_groups", "router_flat_records"):
        if flat_launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "flat path")
    check_levels(torch, "flat", results, batch_ms, levels)
    k256 = results[1, "server 256"]
    n_diff = check_against_plain(torch, "flat path", k256, ref256, 10)
    log(f"  kernel path vs plain path at {q256.n}: scores within tolerance, "
        f"{n_diff} rows with ids differing at non-isolated ties")
    t0 = time.perf_counter()
    ex_s, ex_i = exact_topk(docs.coords, docs.vals, docs.dim, q256.coords,
                            q256.vals, 10)
    torch.cuda.synchronize()
    recall_flat = mean_recall_at_k(k256[1], ex_i)
    log(f"  recall@10 vs exact top-10 ({q256.n} queries, exact in "
        f"{time.perf_counter() - t0:.1f} s): kernel path "
        f"{recall_flat:.4f}, plain path "
        f"{mean_recall_at_k(ref256[1], ex_i):.4f}")
    for fuse, p in levels.items():
        for qs in (q256, q4096):
            log(f"  stages ms, fuse {fuse}, Q={qs.n}: "
                + staged_ms(index, p, qs, run_pipeline_staged))

    # ---- 7. the kNN graph and the hierarchical, refined path
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    index = build_doc_graph(index, degree=GRAPH_DEGREE, batch=GRAPH_BATCH)
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    knn = index.knn_ids
    own = torch.arange(index.n_docs, device=dev)[:, None]
    log(f"[7 graph + hierarchical path] build_doc_graph degree "
        f"{GRAPH_DEGREE}, {-(-index.n_docs // GRAPH_BATCH)} pipeline calls "
        f"of {GRAPH_BATCH}: {t_graph:.1f} s; graph bytes {knn.nbytes}, "
        f"missing edges {int((knn >= index.n_docs).sum())}, self edges "
        f"{int((knn == own).sum())}"
        f"; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    tuned = {f: SearchParams(use_kernel=True, fuse_level=f, **TUNED)
             for f in (0, 1, 2)}
    plain_h = SearchParams(use_kernel=False, fuse_level=0, **TUNED)
    ref_h = search_pipeline(index, q256, plain_h)
    torch.cuda.synchronize()
    runtime.reset_launches()
    CLUSTER_LAUNCHES.clear()
    results_h, batch_ms_h = drive(torch, front_ends(SeismicServer, index,
                                                    tuned),
                                  search_pipeline, q256, q4096)
    hier_launches = dict(runtime.LAUNCHES)
    clusters = dict(sorted(CLUSTER_LAUNCHES.items()))
    log(f"  params {TUNED}; launches {hier_launches}; router_hier launches "
        f"by blocks per query {clusters}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    c_online = row_tiles.cluster_size(ONLINE_BATCH, sms)
    if c_online < 2 or not clusters.get(c_online):
        raise AssertionError(f"router_hier never ran as a cluster of "
                             f"{c_online} blocks for the online batch")
    for name in ("summary_dot", "gather_dot", "gather_dot_cand",
                 "router_hier", "refine_round"):
        if hier_launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "hierarchical, refined path")
    check_levels(torch, "hierarchical", results_h, batch_ms_h, tuned)
    n_diff = check_against_plain(torch, "hierarchical path",
                                 results_h[2, "server 256"], ref_h, 10)
    log(f"  kernel path vs plain path at {q256.n}: scores within tolerance, "
        f"{n_diff} rows with ids differing at non-isolated ties")
    recalls = []
    for rounds in (0, 1, 2):
        p = SearchParams(use_kernel=True, fuse_level=2,
                         **{**TUNED, "refine_rounds": rounds})
        _, ids, ev = search_pipeline(index, q256, p)
        recalls.append((mean_recall_at_k(ids, ex_i), float(ev.float().mean())))
    log(f"  recall@10 vs exact top-10 ({q256.n} queries, fuse 2): "
        + ", ".join(f"refine_rounds {r}: {rc:.4f} (mean docs_evaluated "
                    f"{e:.1f})" for r, (rc, e) in enumerate(recalls)))
    if any(b[0] < a[0] for a, b in zip(recalls, recalls[1:])):
        raise AssertionError("recall@10 fell from one refine round to the "
                             "next")
    for fuse, p in tuned.items():
        for qs in (q256, q4096):
            log(f"  stages ms, fuse {fuse}, Q={qs.n}: "
                + staged_ms(index, p, qs, run_pipeline_staged,
                            split_refine=True))

    # ---- 8. kernels on the main paths' inputs: errors and times
    launches = {n: flat_launches[n] + hier_launches[n] for n in RETRIEVAL}
    bench = Bench(torch, dev)
    p0 = levels[0]
    q_dense, lists, _ = prep_queries(q256.coords, q256.vals, index.dim, p0.cut)
    nb, s = icfg.n_blocks, icfg.summary_nnz
    li = lists.long()
    qn = q256.n
    a_in = (q_dense, index.sum_coords[li].reshape(qn, -1, s),
            index.sum_q[li].reshape(qn, -1, s),
            index.sum_scale[li].reshape(qn, -1),
            index.sum_zero[li].reshape(qn, -1))
    seen: dict[str, object] = {}
    run_pipeline_staged(index, q256.coords, q256.vals, p0,
                        probe=seen.__setitem__)
    cand0 = seen["cand"]
    idx = cand0.long().clamp(0, index.n_docs - 1)
    b_in = (q_dense, take_rows(index.fwd.coords, idx), index.fwd.vals[idx])
    cand1 = torch.sort(cand0, dim=1).values.to(torch.int32)
    c_in = (q_dense, cand1, index.fwd.coords, index.fwd.vals)
    live_ids = cand1[cand1 < index.n_docs]
    n_live = live_ids.numel()
    # a document that is a candidate of several queries is read once
    n_rows = torch.unique(live_ids).numel()
    tiles = cand_tiles_processed(cand1, index.n_docs)
    d_in = (lists, q_dense, index.sum_coords, index.sum_q, index.sum_scale,
            index.sum_zero, index.block_len)
    # the hierarchical path's router inputs and its first refine round
    ph = tuned[2]
    qh, lists_h, _ = prep_queries(q256.coords, q256.vals, index.dim, ph.cut)
    m, f = ph.superblock_budget, FANOUT
    e_in = (lists_h, qh, index.sup_coords, index.sup_q, index.sup_scale,
            index.sup_zero) + d_in[2:]
    seen_h: dict[str, object] = {}
    run_pipeline_staged(index, q256.coords, q256.vals, ph,
                        probe=seen_h.__setitem__, audit=True)
    ids_h = seen_h["merge_ids"]
    f_in = (ids_h, scored_init(ids_h, index.n_docs), qh, index.knn_ids,
            index.fwd.coords, index.fwd.vals)
    rb, flat = router_hier_batch(*e_in, m=m, fanout=f)
    cand_f, _ = refine_round_batch(*f_in, n_docs=index.n_docs,
                                   degree=ph.graph_degree)
    l_, n_, nnz = a_in[1].shape[1], cand0.shape[1], index.fwd.coords.shape[1]
    vb, cb = index.fwd.vals.element_size(), index.fwd.coords.element_size()
    row_b = nnz * (vb + cb) + (8 if index.fwd_scale is not None else 0)
    ns, s2 = icfg.n_superblocks, index.sup_coords.shape[-1]
    nbl = torch.nn.functional.pad(index.block_len > 0, (0, (-nb) % f))
    sup_alive = nbl.reshape(nbl.shape[0], ns, f).any(-1)      # [L, ns]
    # e: block_len rows of the distinct probed lists, their live superblock
    # rows, the distinct scored (list, child) summaries
    lh = lists_h.long()
    lists_e = torch.unique(lh)
    rows_e = int(sup_alive[lists_e].sum())
    alive_e = int(sup_alive[lh].sum())
    live_b = torch.isfinite(rb)
    child = lh.gather(1, (flat // nb).long()) * nb + flat % nb  # [Q, m*f]
    n_child = torch.unique(child[live_b]).numel()

    def q_bytes(qn_, *reads) -> int:
        """Bytes of q a kernel must read: one f32 per distinct (query,
        coordinate) among the entries of the rows it reads. Each read is
        a function of a query range [a, b) that returns (coords [b - a,
        rows, width], live [b - a, rows] or None for all rows); ranges of
        256 queries keep the gathers small at 4096."""
        n_hit = 0
        for a in range(0, qn_, Q_ONLINE):
            b = min(qn_, a + Q_ONLINE)
            hit = torch.zeros(b - a, index.dim, dtype=torch.bool, device=dev)
            for read in reads:
                coords, live = read(a, b)
                c = coords.long().reshape(b - a, -1, coords.shape[-1])
                if live is None:
                    hit.scatter_(1, c.reshape(b - a, -1), True)
                else:
                    qi, ri = live.reshape(b - a, -1).nonzero(as_tuple=True)
                    hit[qi[:, None], c[qi, ri]] = True
            n_hit += int(hit.sum())
        return n_hit * 4

    def fwd_coords(ids):
        return take_rows(index.fwd.coords,
                         ids.long().clamp(0, index.n_docs - 1))

    cand_coords = fwd_coords(cand1)

    def q_hits(qd, *reads) -> float:
        """The share of a kernel's q lookups (the entries of the rows it
        reads; reads as in q_bytes) that hit a non-zero of the query, a set
        bit of its bitmap; the bitmap answers the rest without an L2
        read."""
        nz = (qd.view(torch.int32) != 0).to(torch.uint8)
        n_hit = n = 0
        for coords, live in reads:
            c = coords.long().reshape(qn, -1, coords.shape[-1])
            h = nz.gather(1, c.reshape(qn, -1)).reshape(c.shape)
            if live is not None:
                h = h[live.reshape(qn, -1)]
            n_hit, n = n_hit + int(h.sum()), n + h.numel()
        return n_hit / n

    q_hit = {
        "summary_dot": q_hits(q_dense, (a_in[1], None)),
        "gather_dot_cand": q_hits(q_dense, (cand_coords,
                                            cand1 < index.n_docs)),
        "router_hier": q_hits(qh, (index.sup_coords[lh], sup_alive[lh]),
                              (index.sum_coords.reshape(-1, s)[child.long()],
                               live_b)),
    }
    def rows_of(coords, live=None):
        """A q_bytes read of [Q, rows, width] coords (live [Q, rows])."""
        return lambda a, b: (coords[a:b],
                             None if live is None else live[a:b])

    def flat_route(lists_, qd):
        """router_flat's work on probed lists [Q, cut]: (bytes, operations,
        distinct probed lists, their live block rows, live (query, block)
        rows). It reads the block_len row of each distinct probed list and
        each of their live block summaries once, q at those rows' entries,
        and writes r; 4 operations per entry of a live (query, block)
        row."""
        lq = lists_.long()
        distinct = torch.unique(lq)
        rows_ = int((index.block_len[distinct] > 0).sum())
        alive_ = int((index.block_len[lq] > 0).sum())
        qb = q_bytes(lists_.shape[0], lambda a, b: (
            index.sum_coords[lq[a:b]], index.block_len[lq[a:b]] > 0))
        nbytes = (lists_.nbytes + distinct.numel() * nb * 4
                  + rows_ * (s * 5 + 8) + lists_.shape[0] * CUT * nb * 4 + qb)
        return nbytes, 4 * alive_ * s, distinct.numel(), rows_, alive_

    def refine_work(fin, cand):
        """refine_round's work on (ids, scored, ...) and its frontier
        cand: (bytes, operations, distinct top-k ids, live frontier ids,
        distinct frontier documents). It reads the ids, the seen rows, the
        knn rows of the distinct top-k ids, one forward row per distinct
        live frontier document and q at its entries, and writes both
        outputs; 2 operations per entry of a live frontier row."""
        ids, seen_rows = fin[:2]
        n_top_ = torch.unique(ids[ids >= 0]).numel()
        live = cand[cand < index.n_docs]
        n_front_ = torch.unique(live).numel()
        qb = q_bytes(ids.shape[0], lambda a, b: (
            fwd_coords(cand[a:b]), cand[a:b] < index.n_docs))
        nbytes = (ids.nbytes + seen_rows.nbytes + n_top_ * ph.graph_degree * 4
                  + n_front_ * row_b + cand.numel() * 8 + qb)
        return nbytes, 2 * live.numel() * nnz, n_top_, live.numel(), n_front_

    flat_d = flat_route(lists, q_dense)
    lists_d, rows_d, alive_d = flat_d[2:]
    refine_f = refine_work(f_in, cand_f)
    n_top, n_live_f, n_front = refine_f[2:]
    q_read = {
        "summary_dot": q_bytes(qn, rows_of(a_in[1])),
        "gather_dot": q_bytes(qn, rows_of(b_in[1])),
        "gather_dot_cand": q_bytes(qn, rows_of(cand_coords,
                                               cand1 < index.n_docs)),
        "router_hier": q_bytes(qn, rows_of(index.sup_coords[lh],
                                           sup_alive[lh]),
                               rows_of(index.sum_coords.reshape(-1, s)[
                                   child.long()], live_b)),
    }
    # (bytes, operations) each kernel must move and do: a summary entry
    # costs 4 operations (dequant and multiply-add, two FMAs), a forward
    # entry 2 (one multiply-add)
    work = {
        "summary_dot": (qn * l_ * s * 5 + qn * l_ * 8 + qn * l_ * 4
                        + q_read["summary_dot"], 4 * qn * l_ * s),
        "gather_dot": (qn * n_ * nnz * (vb + cb) + qn * n_ * 4
                       + q_read["gather_dot"], 2 * qn * n_ * nnz),
        "gather_dot_cand": (n_rows * row_b + cand1.nbytes + qn * n_ * 4
                            + q_read["gather_dot_cand"], 2 * n_live * nnz),
        "router_flat": flat_d[:2],
        "router_hier": (
            lists_h.nbytes + lists_e.numel() * nb * 4 + rows_e * (s2 * 5 + 8)
            + n_child * (s * 5 + 8) + qn * m * f * 8 + q_read["router_hier"],
            4 * (alive_e * s2 + int(live_b.sum()) * s)),
        "refine_round": refine_f[:2],
    }
    bounds = {name: bound(*w) for name, w in work.items()}

    def library_bag(coords, weights):
        """One ``F.embedding_bag`` (mode="sum", per-sample weights) over
        coords pre-offset by q * d into the flattened q_dense, with the
        values converted outside the timed call."""
        off = (coords.long() + (torch.arange(coords.shape[0], device=dev)
                                * index.dim)[:, None, None])
        off = off.reshape(-1, coords.shape[-1])
        w = weights.reshape(off.shape).float().contiguous()
        table = q_dense.reshape(-1, 1)
        return lambda: torch.nn.functional.embedding_bag(
            off, table, per_sample_weights=w, mode="sum")

    a_deq = dequantize_u8(a_in[2], a_in[3], a_in[4])
    hier_kernel = lambda: router_hier_batch(*e_in, m=m, fanout=f)  # noqa: E731
    hier_plain = lambda: router_hier_ref(*e_in, m=m, fanout=f)     # noqa: E731
    refine_kernel = lambda: refine_round_batch(  # noqa: E731
        *f_in, n_docs=index.n_docs, degree=ph.graph_degree)
    refine_plain = lambda: refine_round_ref(  # noqa: E731
        *f_in, None, None, index.n_docs, ph.graph_degree)
    rows = {
        "summary_dot": (lambda: summary_dot_batch(*a_in),
                        lambda: summary_dot_batch_ref(*a_in),
                        library_bag(a_in[1], a_deq)),
        "gather_dot": (lambda: gather_dot_batch(*b_in),
                       lambda: gather_dot_batch_ref(*b_in),
                       library_bag(b_in[1], b_in[2])),
        "gather_dot_cand": (
            lambda: gather_dot_cand_batch(*c_in, n_docs=index.n_docs),
            lambda: gather_dot_cand_ref(*c_in, None, None, index.n_docs),
            None),
        "router_flat": (lambda: router_flat_batch(*d_in),
                        lambda: router_flat_ref(*d_in), None),
        "router_hier": (lambda: hier_kernel()[0], lambda: hier_plain()[0],
                        None),
        "refine_round": (lambda: refine_kernel()[1],
                         lambda: refine_plain()[1], None),
    }
    # summary_dot on the hierarchical path's fuse-0 inputs: the superblock
    # tier [Q, cut * ns, S2] and the children [Q, m * f, S] that
    # router_hier_ref hands it
    unfused: list[tuple] = []

    def capture(*a):
        unfused.append(a)
        return summary_dot_batch_ref(*a)
    router_hier_ref(*e_in, m=m, fanout=f, dot=capture)
    for a, what in zip(unfused, ("superblock tier", "children")):
        e = compare(torch, f"summary_dot, hierarchical fuse 0 {what}",
                    summary_dot_batch(*a), summary_dot_batch_ref(*a))
        log(f"  summary_dot on the hierarchical fuse-0 {what} "
            f"{list(a[1].shape)}: max abs {e[0]:.3e} rel {e[1]:.3e}")
    del unfused, a             # 0.5 GB of gathered rows, before the timing
    if not torch.equal(hier_kernel()[1], hier_plain()[1]):
        raise AssertionError("router_hier: flat positions differ from the "
                             "plain version on the main path's inputs")
    if not torch.equal(refine_kernel()[0], refine_plain()[0]):
        raise AssertionError("refine_round: frontier ids differ from the "
                             "plain version on the main path's inputs")
    record = []
    for name, (kern, ref, lib) in rows.items():
        abs_err, rel_err = compare(torch, name, kern(), ref())
        ms = bench.ms(kern, iters=20)
        plain_ms = bench.ms(ref, iters=5, warmup=1)
        lib_ms = None if lib is None else bench.ms(lib, iters=10)
        bms, by = bounds[name]
        src, rep = SOURCES[name]
        record.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[name], max_abs_err=abs_err, ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=lib_ms))
        log(f"[8 {name}] {ms:.4f} ms (bound {bms:.4f} ms by {by}, "
            f"{bms / ms:.1%} of it; {work[name][0] / ms / 1e6:.1f} GB/s of "
            f"the {work[name][0]} bytes it must move), plain "
            f"{plain_ms:.3f} ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; max abs "
            f"err {abs_err:.3e}, rel {rel_err:.3e}; launches flat path "
            f"{flat_launches[name]}, hierarchical path {hier_launches[name]}")
    log(f"  gather_dot_cand: {n_live} live (query, candidate) pairs of "
        f"{cand1.numel()} over {n_rows} distinct documents (the rows its "
        f"bound counts), {int(tiles.sum())} of {tiles.numel()} tiles "
        "processed")
    log("  share of q lookups that hit a non-zero of the query (the rest "
        "the kernel's bitmap answers): " + ", ".join(
            f"{n} {h:.4f}" for n, h in q_hit.items()))
    log(f"  router_flat: {lists_d} distinct probed lists with {rows_d} live "
        f"block summaries (the rows its bound counts), {alive_d} live "
        f"(query, block) rows of {qn * CUT * nb}: reuse {alive_d / rows_d:.3f}"
        f"; router_hier: {lists_e.numel()} distinct probed lists with "
        f"{rows_e} live superblock summaries, {alive_e} live (query, "
        f"superblock) rows of {qn * ph.cut * ns}, {int(live_b.sum())} scored "
        f"children over {n_child} distinct (list, block) summaries; "
        f"refine_round: knn rows of {n_top} distinct top-k ids, {n_live_f} "
        f"live frontier ids of {cand_f.numel()} over {n_front} distinct "
        "documents")
    log("  q bytes in the bounds, per kernel (distinct (query, coordinate) "
        "reads): " + ", ".join(f"{n} {b}" for n, b in q_read.items()))
    # refine_round looks q up in L2 at every entry of its live rows: the
    # 32-byte sectors of q_dense those lookups touch, against the 122 KB
    # pass over each query's row that a bitmap would be built from
    f_live = cand_f < index.n_docs
    f_rows = fwd_coords(cand_f).long() // 8                # sector indices
    f_sect = (torch.arange(qn, device=dev)[:, None, None] * (-(-index.dim
              // 8)) + f_rows)[f_live]
    n_sect = torch.unique(f_sect).numel()
    log(f"  refine_round q lookups: {int(f_live.sum()) * nnz} over "
        f"{n_sect} distinct 32-byte sectors of q_dense ({n_sect * 32} B, "
        f"{n_sect * 32 / qn / 1024:.1f} KB a query; a bitmap would read "
        f"{index.dim * 4 / 1024:.1f} KB a query)")
    # d and f on the 4096-query batch's inputs, their bounds counted alike;
    # checked against the plain versions 512 queries at a time
    qd4, lists4, _ = prep_queries(q4096.coords, q4096.vals, index.dim,
                                  p0.cut)
    d4 = (lists4, qd4) + d_in[2:]
    qh4, _, _ = prep_queries(q4096.coords, q4096.vals, index.dim, ph.cut)
    seen4: dict[str, object] = {}
    run_pipeline_staged(index, q4096.coords, q4096.vals, ph,
                        probe=seen4.__setitem__, audit=True)
    ids4 = seen4["merge_ids"]
    del seen4
    f4 = (ids4, scored_init(ids4, index.n_docs), qh4, index.knn_ids,
          index.fwd.coords, index.fwd.vals)
    cand4, _ = refine_round_batch(*f4, n_docs=index.n_docs,
                                  degree=ph.graph_degree)
    flat4, refine4 = flat_route(lists4, qd4), refine_work(f4, cand4)
    for name, kern, ref, w4 in (
            ("router_flat", lambda: router_flat_batch(*d4),
             lambda a, b: router_flat_ref(lists4[a:b], qd4[a:b], *d4[2:]),
             flat4),
            ("refine_round",
             lambda: refine_round_batch(*f4, n_docs=index.n_docs,
                                        degree=ph.graph_degree),
             lambda a, b: refine_round_ref(
                 *(x[a:b] for x in f4[:3]), *f4[3:], None, None,
                 index.n_docs, ph.graph_degree), refine4)):
        out = kern()
        out = out if name == "router_flat" else out[1]
        err = 0.0
        for a in range(0, Q_BATCH, 512):
            want = ref(a, a + 512)
            want = want if name == "router_flat" else want[1]
            err = max(err, compare(torch, f"{name} Q={Q_BATCH}",
                                   out[a:a + 512], want)[0])
        del out, want
        ms = bench.ms(kern, iters=10)
        bms, by = bound(*w4[:2])
        log(f"[8 {name} Q={Q_BATCH}] {ms:.4f} ms (bound {bms:.4f} ms by "
            f"{by}, {bms / ms:.1%} of it; {w4[0] / ms / 1e6:.1f} GB/s of the "
            f"{w4[0]} bytes it must move); max abs err {err:.3e}")
    log(f"  router_flat Q={Q_BATCH}: {flat4[2]} distinct probed lists with "
        f"{flat4[3]} live block summaries, {flat4[4]} live (query, block) "
        f"rows: reuse {flat4[4] / flat4[3]:.3f} (at {qn}: "
        f"{alive_d / rows_d:.3f}); refine_round Q={Q_BATCH}: knn rows of "
        f"{refine4[2]} distinct top-k ids, {refine4[3]} live frontier ids "
        f"over {refine4[4]} distinct documents")
    del d4, f4, qd4, qh4, cand4
    empty_ms = bench.ms(lambda: empty_launch(dev), iters=20)
    log(f"  an empty kernel's launch, timed alike: {empty_ms:.4f} ms (the "
        f"floor under refine_round's {record[-1]['ms']:.4f} ms)")
    # router_hier at every cluster size, at the servers' two batches and
    # one between them: the wrapper takes the most blocks per query that
    # still have an SM each (row_tiles.cluster_size)
    chosen, sweep = row_tiles.cluster_size, []
    try:
        for nq in (qn, 32, ONLINE_BATCH):
            ins = (lists_h[:nq].contiguous(), qh[:nq].contiguous()) + e_in[2:]
            for c in (1, 2, 4, 8):
                row_tiles.cluster_size = lambda *_, c=c: c
                t = bench.ms(lambda: router_hier_batch(*ins, m=m, fanout=f),
                             iters=10)
                star = "*" if c == chosen(nq, sms) else ""
                sweep.append(f"Q {nq} C {c}{star} {t:.4f} ms")
    finally:
        row_tiles.cluster_size = chosen
    log("  router_hier by blocks per query (* the wrapper's choice on "
        f"{sms} SMs): " + ", ".join(sweep))
    return record, dict(index=index, queries=q256, recall_flat=recall_flat,
                        recall_tuned=recalls[2][0])



def plain_on_kernel_route(torch, index, q, name, kernel_p, plain_p):
    """The plain path's answers on the kernel's route, for a check that
    holds where router scores tie. The router's kernel (summary_dot at
    fuse 0; router_flat and router_hier equal it bitwise, which the level
    checks assert) is held to its plain version on the plain route's own
    rows, every tier. Where router scores tie in the plain order, another
    summation order may keep other blocks, so the stages after the router
    run their plain versions (use_kernel=False, fuse 0) on the kernel's
    route, and the kernel path is held to them (``check_against_plain``).
    """
    from repro_torch.kernels.router_fused.ops import (router_flat_ref,
                                                      router_hier_ref)
    from repro_torch.kernels.summary_dot.ops import (summary_dot_batch,
                                                     summary_dot_batch_ref)
    from repro_torch.retrieval.pipeline import stage_fns
    fk, fp = stage_fns(index, kernel_p), stage_fns(index, plain_p)
    q_dense, lists, _ = fp["prep"](q.coords, q.vals)
    tiers = []

    def capture(*a):
        tiers.append(a)
        return summary_dot_batch_ref(*a)
    flat = (index.sum_coords, index.sum_q, index.sum_scale, index.sum_zero,
            index.block_len)
    if plain_p.superblock_fanout:
        router_hier_ref(lists, q_dense, index.sup_coords, index.sup_q,
                        index.sup_scale, index.sup_zero, *flat,
                        m=plain_p.superblock_budget,
                        fanout=plain_p.superblock_fanout, dot=capture)
    else:
        router_flat_ref(lists, q_dense, *flat, dot=capture)
    for a in tiers:
        compare(torch, f"{name} summary_dot {list(a[1].shape)} on the plain "
                "route's rows", summary_dot_batch(*a), summary_dot_batch_ref(*a))
    del tiers
    batch = fk["router"](q_dense, lists)
    sel = fp["selector"](batch)
    cand, scores = fp["scorer"](batch, sel)
    return fp["refine"](q_dense, *fp["merge"](cand, scores))

def on_card(index, what: str) -> None:
    """Every tensor of a published snapshot lies on the card."""
    planes = dict(index._tensor_fields(), **{"fwd.coords": index.fwd.coords,
                                              "fwd.vals": index.fwd.vals})
    off = [n for n, t in planes.items() if t is not None and not t.is_cuda]
    if off:
        raise AssertionError(f"{what}: planes {off} are not on the card")


def summaries_bound(torch, index, lists) -> tuple[int, int]:
    """For each list of ``lists``: every live block's summary (dequantized,
    float64) plus half a quantization step is at least each live member's
    value at every coordinate the summary keeps (the coordinate-wise max
    of the members, which alpha-mass prunes to a subset; the member's
    bf16 forward value is taken 2^-8 relative down, since a block the
    builder summarized from the float32 collection may hold a member
    whose bf16 rounding went up by up to 2^-9); every superblock summary
    is at least each live child's dequantized value at the child's
    coordinates (round-up quantization; 1e-6 relative for the rounding
    of the stored scales). -> (block entries, child entries) checked."""
    cfg = index.config
    cap, f = index.n_docs, cfg.superblock_fanout

    def deq(q, scale, zero):
        v = (q.double() - 1) * scale.double()[..., None] \
            + zero.double()[..., None]
        return torch.where(q > 0, v, 0.0)
    n_blk = n_kid = 0
    for ell in lists.tolist():
        bl = index.block_len[ell].long()
        live_b = (bl > 0).nonzero().flatten()
        sc = index.sum_coords[ell].long()                      # [nb, S]
        sq = index.sum_q[ell]
        sv = deq(sq, index.sum_scale[ell], index.sum_zero[ell])
        half = 0.5 * index.sum_scale[ell].double()
        blk = torch.repeat_interleave(live_b, bl[live_b])
        start = torch.cumsum(bl[live_b], 0) - bl[live_b]
        pos = index.block_off[ell].long()[blk] + torch.arange(
            blk.numel(), device=blk.device) - torch.repeat_interleave(
            start, bl[live_b])
        docs = index.list_docs[ell, pos].long()
        keep = docs < cap
        blk, docs = blk[keep], docs[keep]
        for a in range(0, docs.numel(), 1024):
            d_, b_ = docs[a:a + 1024], blk[a:a + 1024]
            rc = index.fwd.coords[d_].long()                   # [M, nnz]
            rv = index.fwd.vals[d_].float()
            hit = rc[:, :, None] == sc[b_][:, None, :]         # [M, nnz, S]
            mv = torch.where(hit, rv[:, :, None], 0.0).amax(1).double()
            kept = sq[b_] > 0
            ok = mv * (1 - 2 ** -8) <= sv[b_] + half[b_, None]
            if not bool(ok[kept].all()):
                raise AssertionError(f"list {ell}: a block summary is below "
                                     "a member's value")
            n_blk += int(kept.sum())
        if index.sup_coords is None:
            continue
        pc = index.sup_coords[ell].long()                      # [ns, S2]
        pq = index.sup_q[ell]
        pv = deq(pq, index.sup_scale[ell], index.sup_zero[ell])
        g = live_b // f
        match = (sc[live_b][:, :, None] == pc[g][:, None, :]) \
            & (pq[g][:, None, :] > 0)                          # [B, S, S2]
        sup_at = torch.where(match, pv[g][:, None, :], -1.0).amax(-1)
        kept = sq[live_b] > 0
        ok = sup_at >= sv[live_b] * (1 - 1e-6)
        if not bool(ok[kept].all()):
            raise AssertionError(f"list {ell}: a superblock summary is below "
                                 "a child's value")
        n_kid += int(kept.sum())
    return n_blk, n_kid


def mutation_phase(torch, dev, args, runtime, smi, index, q_base) -> dict:
    """Phase 12: the mutation path on phase 7's index (kNN graph,
    superblock tier, bf16 forward plane) at the MS MARCO widths: lift,
    inserts with auto-compaction, deletes, a final compaction, served
    through ``SeismicServer.apply_mutation`` at three points, a save and
    load. Returns the launches per kernel on the mutated index."""
    import shutil

    from repro_torch.ckpt import load_index, save_index
    from repro_torch.core import build_index, make_mutable
    from repro_torch.core.oracle import exact_topk, mean_recall_at_k
    from repro_torch.data import SyntheticSparseConfig, make_collection
    from repro_torch.graph import build_doc_graph
    from repro_torch.obs import MetricsRegistry
    from repro_torch.retrieval import SearchParams, search_pipeline
    from repro_torch.serve import SeismicServer
    from repro_torch.serve.telemetry import ServerTelemetry
    from repro_torch.sparse.ops import PaddedSparse

    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    n_base = index.n_docs
    cap = n_base + MUT_INSERTS
    # the inserts, and half the queries, from the synthetic distribution
    # with another seed, so inserted docs are answers too
    new, new_q, _ = make_collection(SyntheticSparseConfig(
        dim=DIM, n_docs=MUT_INSERTS, n_queries=Q_ONLINE // 2,
        doc_nnz=DOC_NNZ, query_nnz=QUERY_NNZ, seed=args.seed + 1),
        device=dev)
    half = Q_ONLINE - new_q.n
    q = PaddedSparse(torch.cat([q_base.coords[:half], new_q.coords]),
                     torch.cat([q_base.vals[:half], new_q.vals]), DIM)
    reg = MetricsRegistry()
    t0 = time.perf_counter()
    mut = make_mutable(index, capacity=cap, tail_cap=MUT_TAIL,
                       tail_max=MUT_TAIL, registry=reg)
    del index
    torch.cuda.synchronize()
    log(f"[12 mutation] on {smi}: {n_base} docs lifted to capacity {cap} "
        f"(tail of {MUT_TAIL}) in {time.perf_counter() - t0:.3f} s; "
        f"{MUT_INSERTS} docs to insert in chunks of {MUT_CHUNK}")
    on_card(mut.index, "the lifted snapshot")
    base = dict(k=10, cut=CUT, block_budget=BLOCK_BUDGET)
    paths = {"flat": base, "tuned": TUNED}
    levels = {name: {f: SearchParams(use_kernel=True, fuse_level=f, **kw)
                     for f in (0, 1, 2)} for name, kw in paths.items()}
    plain = {name: SearchParams(use_kernel=False, fuse_level=0, **kw)
             for name, kw in paths.items()}
    servers = {name: front_ends(SeismicServer, mut.index, lv,
                                telemetry=ServerTelemetry)
               for name, lv in levels.items()}
    # a–f: d's three kernels on the flat path at fuse 2, e and f on the
    # tuned path at fuse 2, b at fuse 0, a at fuse 0 and 1, c at 1 and 2
    kernels = ("summary_dot", "gather_dot", "gather_dot_cand", "router_flat",
               "router_flat_groups", "router_flat_records", "router_hier",
               "refine_round")
    launches = {}
    batch_ms = {}
    failed = []        # recall gates, raised once the phase has measured all

    def serve(point: str) -> None:
        for fe in servers.values():
            for server, online in fe.values():
                server.apply_mutation(mut)
                online.apply_mutation(mut)
        epoch = servers["flat"][0][0].epoch
        torch.cuda.synchronize()
        runtime.reset_launches()
        results = {name: drive(torch, fe, search_pipeline, q)
                   for name, fe in servers.items()}
        counted = dict(runtime.LAUNCHES)
        log(f"  {point} (serving epoch {epoch}, index epoch {mut.epoch}, "
            f"tail {mut.tail_occupancy}, live {mut.n_live}): launches "
            f"{counted}")
        for name in kernels:
            if counted[name] <= 0:
                raise AssertionError(f"kernel {name} never launched on "
                                     f"the mutated index ({point})")
        for name in RETRIEVAL:
            launches[name] = launches.get(name, 0) + counted[name]
        tomb = mut.index.tombstone
        for name, (res, ms) in results.items():
            check_levels(torch, f"{point} {name}", res, ms, levels[name],
                         labels=LABELS[:2])
            ref = plain_on_kernel_route(torch, mut.index, q, name,
                                        levels[name][0], plain[name])
            n_diff = check_against_plain(torch, f"{point} {name}",
                                         res[2, "server 256"], ref, 10)
            e2e = search_pipeline(mut.index, q, plain[name])
            n_route = int((e2e[1] != res[2, "server 256"][1]).any(1).sum())
            for out in list(res.values()) + [ref, e2e]:
                ids = out[1][out[1] >= 0].long()
                if bool(tomb[ids].any()):
                    raise AssertionError(f"{point} {name}: a deleted id "
                                         "was returned")
            batch_ms[point, name] = (ms[2, "server 256"], ms[2, ONLINE])
            tel = servers[name][2][0].telemetry.export()
            log(f"  {point} {name}: summary_dot on the plain route's rows "
                "within tolerance; kernel path vs the plain stages on its "
                f"route: scores within tolerance, {n_diff} rows with ids "
                "differing at non-isolated ties; the plain path end to end "
                f"keeps other blocks at router ties in {n_route} of {q.n} "
                "rows; no deleted id returned; fuse 2 ms per "
                f"batch of {Q_ONLINE} "
                f"{['%.2f' % t for t in ms[2, 'server 256']]}, per "
                f"{ONLINE_REQUESTS} online requests "
                f"{['%.2f' % t for t in ms[2, ONLINE]]}; telemetry launch "
                f"p50 {tel['latency_s']['launch']['p50'] * 1e3:.2f} ms over "
                f"{tel['batch']['launches']} launches ({smi})")

    def recall_vs_fresh(point: str) -> None:
        """recall@10 against the exact top-10 of the equivalent corpus
        (deleted and unassigned rows all zero), mutated against a fresh
        build (and graph) of that corpus at the same parameters."""
        idx = mut.index
        dead = idx.tombstone.clone()
        dead[mut.n_docs:] = True
        corpus = PaddedSparse(torch.where(dead[:, None], 0, idx.fwd.coords),
                              torch.where(dead[:, None], 0.0,
                                          idx.fwd.vals.float()), DIM)
        t0 = time.perf_counter()
        _, ex_i = exact_topk(corpus.coords, corpus.vals, DIM, q.coords,
                             q.vals, 10)
        fresh = build_doc_graph(build_index(corpus, idx.config),
                                degree=GRAPH_DEGREE, batch=GRAPH_BATCH)
        torch.cuda.synchronize()
        t_fresh = time.perf_counter() - t0
        for name, lv in levels.items():
            r_mut = mean_recall_at_k(search_pipeline(idx, q, lv[2])[1], ex_i)
            r_fresh = mean_recall_at_k(search_pipeline(fresh, q, lv[2])[1],
                                       ex_i)
            log(f"  {point} {name}: recall@10 {r_mut:.4f}, a fresh build of "
                f"the same corpus {r_fresh:.4f} (ratio "
                f"{r_mut / r_fresh:.4f}, gate {RECALL_RATIO}); exact top-10, "
                f"fresh build and graph {t_fresh:.1f} s ({smi})")
            if r_mut < RECALL_RATIO * r_fresh:
                failed.append(f"{point} {name}: recall@10 {r_mut:.4f} < "
                              f"{RECALL_RATIO} x fresh {r_fresh:.4f}")

    serve("lifted")
    h_comp = reg.get("seismic_compaction_seconds").labels()
    n_minor = reg.get("seismic_compaction_lists_minor_total").labels()
    n_major = reg.get("seismic_compaction_lists_major_total").labels()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    deleted = None
    for i in range(0, MUT_INSERTS, MUT_CHUNK):
        if i + MUT_CHUNK == MUT_INSERTS:
            # before the last chunk: 5 % of the base, 10 % of the inserted
            n_del = round(MUT_DELETE_BASE * n_base)
            n_new = round(MUT_DELETE_NEW * i)
            deleted = torch.cat([
                torch.randperm(n_base, generator=gen, device=dev)[:n_del],
                n_base + torch.randperm(i, generator=gen, device=dev)[:n_new]])
            t0 = time.perf_counter()
            mut.delete_docs(deleted)
            torch.cuda.synchronize()
            log(f"  delete {n_del} base and {n_new} inserted docs: "
                f"{time.perf_counter() - t0:.3f} s ({smi})")
            on_card(mut.index, "the snapshot after the delete")
            serve("during")            # a full tail and mask-only deletes
            recall_vs_fresh("during")
        comp = (h_comp.n, h_comp.total, n_minor.value, n_major.value)
        t0 = time.perf_counter()
        mut.insert_docs(new.coords[i:i + MUT_CHUNK], new.vals[i:i + MUT_CHUNK])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        t_comp = h_comp.total - comp[1]
        msg = (f"  insert {MUT_CHUNK} docs: {dt:.3f} s, "
               f"{MUT_CHUNK / (dt - t_comp):.0f} docs/s without compaction")
        if h_comp.n > comp[0]:
            msg += (f"; it compacted first: {t_comp:.3f} s, "
                    f"{n_minor.value - comp[2]} lists minor, "
                    f"{n_major.value - comp[3]} major")
        log(msg + f" ({smi})")
        on_card(mut.index, f"the snapshot after insert {i // MUT_CHUNK}")
    comp = (h_comp.total, n_minor.value, n_major.value)
    mut.compact()
    torch.cuda.synchronize()
    log(f"  final compaction: {h_comp.total - comp[0]:.3f} s, "
        f"{n_minor.value - comp[1]} lists minor, {n_major.value - comp[2]} "
        f"major; {h_comp.n} compactions in "
        f"{h_comp.total:.3f} s ({smi})")
    on_card(mut.index, "the compacted snapshot")
    if mut.n_live != cap - deleted.numel():
        raise AssertionError(f"{mut.n_live} live docs, expected "
                             f"{cap - deleted.numel()}")
    serve("after")
    recall_vs_fresh("after")
    # the summaries of a seeded sample of the compacted lists
    touched = torch.unique(new.coords[new.vals > 0])
    pick = touched[torch.randperm(touched.numel(), generator=gen,
                                  device=dev)[:BOUND_LISTS]]
    t0 = time.perf_counter()
    n_blk, n_kid = summaries_bound(torch, mut.index, pick)
    log(f"  summaries of {pick.numel()} compacted lists bound their members "
        f"({n_blk} block entries) and superblocks their children ({n_kid} "
        f"child entries), {time.perf_counter() - t0:.1f} s ({smi})")
    # save and load: bitwise equal planes and answers
    path = ROOT / "build" / "mutation_index"
    shutil.rmtree(path, ignore_errors=True)
    total = mut.index.nbytes()["total"]
    log(f"  {total} bytes to save; {shutil.disk_usage(ROOT).free} bytes "
        "free on the checkout's disk")
    t0 = time.perf_counter()
    save_index(str(path), mut.index, step=1)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_index(str(path), device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    shutil.rmtree(path, ignore_errors=True)
    planes = dict(mut.index._tensor_fields(), **{
        "fwd.coords": mut.index.fwd.coords, "fwd.vals": mut.index.fwd.vals})
    got = dict(loaded._tensor_fields(), **{"fwd.coords": loaded.fwd.coords,
                                            "fwd.vals": loaded.fwd.vals})
    differ = [n for n, t in planes.items() if (t is None) != (got[n] is None)
              or t is not None and (t.dtype != got[n].dtype
                                    or not torch.equal(t, got[n]))]
    if differ or loaded.config != mut.index.config:
        raise AssertionError(f"save/load: planes {differ} differ")
    for name, lv in levels.items():
        if not same_results(torch, search_pipeline(loaded, q, lv[2]),
                            search_pipeline(mut.index, q, lv[2])):
            raise AssertionError(f"save/load: {name} answers differ")
    del loaded
    log(f"  save_index {t_save:.1f} s, load_index {t_load:.1f} s: every "
        "plane bitwise equal, the same answers at fuse 2; ms per batch "
        f"of {Q_ONLINE} at fuse 2, lifted / during / after: " + "; ".join(
            f"{name} " + " / ".join(
                f"{sorted(batch_ms[p, name][0])[1]:.2f}"
                for p in ("lifted", "during", "after"))
            for name in paths)
        + f"; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; phase 12 "
        f"in {time.perf_counter() - t_phase:.1f} s ({smi})")
    if failed:
        raise AssertionError("; ".join(failed))
    return launches


def serving_traffic(seed: int) -> list[tuple[int, int]]:
    """Phase 13's request stream over the 256 queries: (query, burst size)
    units. Each query's first occurrence is a miss (SERVE_BURSTS of them
    come as a burst of 4 identical requests, which coalesce); every other
    unit repeats a query whose first occurrence came earlier (a cache
    hit, or coalesced while that one is in flight)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    first = rng.permutation(Q_ONLINE)
    bursts = set(rng.choice(Q_ONLINE, SERVE_BURSTS, replace=False).tolist())
    n_units = SERVE_REQUESTS - 3 * SERVE_BURSTS
    kinds = np.zeros(n_units, bool)
    kinds[rng.choice(np.arange(1, n_units), Q_ONLINE - 1,
                     replace=False)] = True
    kinds[0] = True
    units, seen = [], 0
    for new in kinds:
        if new:
            q = int(first[seen])
            seen += 1
            units.append((q, 4 if q in bursts else 1))
        else:
            units.append((int(first[rng.integers(seen)]), 1))
    return units


def drive_clients(server, units, c, v, rate, seed, halves=1, between=None):
    """SERVE_CLIENTS client threads submit ``units`` (round robin) with
    Poisson arrivals of ``rate`` requests/s in all, ``halves`` times over;
    between two halves every client waits at a barrier while the main
    thread runs ``between()``. Returns ([(half, query, future)], seconds
    from the first submission to the last answer, seconds from the first
    submission to the last)."""
    import numpy as np
    subs: list[list] = [[] for _ in range(SERVE_CLIENTS)]
    last = [0.0] * SERVE_CLIENTS
    barrier = threading.Barrier(SERVE_CLIENTS + 1)
    done_between = threading.Event()
    errors = []

    def client(cid: int) -> None:
        try:
            rng = np.random.default_rng(seed * 100 + cid)
            mine = units[cid::SERVE_CLIENTS]
            for half in range(halves):
                for q, size in mine:
                    time.sleep(rng.exponential(size * SERVE_CLIENTS / rate))
                    for _ in range(size):
                        subs[cid].append((half, q, server.submit(c[q], v[q])))
                    last[cid] = time.monotonic()
                if half + 1 < halves:
                    barrier.wait(timeout=SERVE_TIMEOUT)
                    done_between.wait(timeout=SERVE_TIMEOUT)
        except Exception as e:   # noqa: BLE001 — reported below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=client, args=(cid,))
               for cid in range(SERVE_CLIENTS)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for _ in range(halves - 1):
        barrier.wait(timeout=SERVE_TIMEOUT)
        between()
        done_between.set()
    for t in threads:
        t.join(timeout=SERVE_TIMEOUT)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"a client failed: {errors}")
    out = [s for sub in subs for s in sub]
    for _, _, fut in out:
        if not fut.wait(SERVE_TIMEOUT):
            raise AssertionError("a request is still pending")
    return out, time.monotonic() - t0, max(last) - t0


def check_answers(label, subs, refs, accept=None) -> dict:
    """Every future ``done`` with ids, scores and docs_evaluated bitwise
    the 256-query server's at its point (``refs[half]``; a first-half
    request may also carry ``accept``'s answer, served after a swap).
    Returns counts of cached, coalesced and late answers."""
    import numpy as np
    counts = {"cached": 0, "coalesced": 0, "after swap": 0}
    for half, q, fut in subs:
        if fut.status != "done":
            raise AssertionError(f"{label}: a request ended {fut.status}")
        r = fut.result(0)

        def same(ref):
            s, i, e = ref
            return (np.array_equal(r.ids, i[q]) and
                    np.array_equal(r.scores.view(np.int32),
                                   s[q].view(np.int32))
                    and r.docs_evaluated == e[q])
        if not same(refs[half]):
            if half == 0 and accept is not None and same(accept):
                counts["after swap"] += 1
            else:
                raise AssertionError(
                    f"{label}: request for query {q} (part {half}) differs "
                    "from the 256-query server's answer")
        counts["cached"] += r.cached
        counts["coalesced"] += r.coalesced
    return counts


def latency_line(subs, seconds, submitted) -> str:
    import numpy as np
    all_ = np.array([f.result(0).latency_s for _, _, f in subs]) * 1e3
    launched = np.array([f.result(0).latency_s for _, _, f in subs
                         if not f.result(0).cached]) * 1e3
    def p(a):
        return "/".join(f"{x:.3f}" for x in np.percentile(a, (50, 95, 99)))
    return (f"{len(subs)} requests arrived at {len(subs) / submitted:.1f}"
            f"/s, answered in {seconds:.2f} s: {len(subs) / seconds:.1f} "
            "QPS; latency p50/p95/p99 ms, all "
            f"{p(all_)}, not cached {p(launched)}")


def registry_values(reg) -> dict:
    """The registry's samples keyed as ``parse_prometheus_text`` keys
    them, each value as the text renders it."""
    out = {}
    for fam in reg.collect():
        for values, child in fam.samples():
            labels = tuple(sorted(zip(fam.label_names, values)))
            if fam.kind == "histogram":
                out[fam.name + "_count", labels] = float(child.n)
                out[fam.name + "_sum", labels] = float(
                    f"{child.total:.9g}")
            else:
                out[fam.name, labels] = float(f"{child.value:.9g}")
    return out


def launch_means(tracer) -> str:
    """Mean launch span of staged and fused launches (one per batch)."""
    import numpy as np
    spans = {}
    for tr in tracer.finished():
        for s in tr.spans:
            if s.name == "launch" and "batch_seq" in s.attrs:
                spans[s.attrs["batch_seq"], s.attrs.get("replica")] = (
                    s.attrs["staged"], s.duration_s)
    parts = []
    for kind, staged in (("staged", True), ("fused", False)):
        d = [t for st, t in spans.values() if st == staged]
        parts.append(f"{kind} {len(d)} x {np.mean(d) * 1e3:.3f} ms"
                     if d else f"{kind} none")
    return ", ".join(parts)


def stage_bytes(reg) -> str:
    snap = reg.snapshot()
    modeled = {s["labels"]["stage"]: s["value"] for s in
               snap["seismic_stage_modeled_bytes_per_query"]["samples"]}
    rate = {s["labels"]["stage"]: s["value"] for s in snap.get(
        "seismic_stage_achieved_bytes_per_second", {"samples": []})
        ["samples"]}
    return ", ".join(f"{k} {modeled[k]:.0f} B/query, "
                     f"{rate.get(k, 0.0) / 1e9:.2f} GB/s" for k in modeled)


def serving_phase(torch, dev, args, runtime, smi, kept) -> dict:
    """Phase 13: async micro-batching, mirror replicas and the
    observability plane on phase 7's index. Returns the launches per
    kernel."""
    import numpy as np

    from repro_torch.core.oracle import exact_topk, mean_recall_at_k
    from repro_torch.kernels.router_fused.ops import CLUSTER_LAUNCHES
    from repro_torch.obs import (MetricsRegistry, Observability,
                                 ShadowAuditor, parse_prometheus_text,
                                 prometheus_text, start_exporter,
                                 validate_trace)
    from repro_torch.retrieval import (SearchParams, run_pipeline_staged,
                                       search_pipeline)
    from repro_torch.serve import (AsyncSeismicServer, ReplicaSeismicServer,
                                   SeismicServer)
    from repro_torch.tune.policy import TunedPolicy, attach_tuned

    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    index = attach_tuned(kept["index"], [TunedPolicy(
        target=0.95, modeled=True, **TUNED)])
    q256 = kept["queries"]
    points = {"TUNED": SearchParams(use_kernel=True, fuse_level=2, **TUNED),
              "flat": SearchParams(use_kernel=True, fuse_level=2, k=10,
                                   cut=CUT, block_budget=BLOCK_BUDGET)}
    c = q256.coords.cpu().numpy()
    v = q256.vals.cpu().numpy()
    # the 256-query server's answers, and their recall@10 against the
    # exact top-10 over the forward plane, the auditor's referent (phases
    # 6 and 7 measure against the float32 collection)
    _, exact_fwd = exact_topk(index.fwd.coords, index.fwd.vals, DIM,
                              q256.coords, q256.vals, 10)
    refs, offline = {}, {}
    for name, p in points.items():
        r = SeismicServer(index, p, max_batch=Q_ONLINE).search(q256)
        refs[name] = tuple(t.cpu().numpy() for t in
                           (r.scores, r.ids, r.docs_evaluated))
        offline[name] = mean_recall_at_k(r.ids, exact_fwd)
    # launches of one pipeline run at each point, fused and staged
    per_run = {}
    for name, p in points.items():
        for staged in (False, True):
            runtime.reset_launches()
            if staged:
                run_pipeline_staged(index, q256.coords[:8], q256.vals[:8], p,
                                    split_refine=True)
            else:
                search_pipeline(index, q256[:8], p)
            torch.cuda.synchronize()
            counted = {k: n for k, n in runtime.LAUNCHES.items() if n}
            if staged and counted != per_run[name]:
                raise AssertionError(f"{name}: a staged run launches "
                                     f"{counted}, a fused one "
                                     f"{per_run[name]}")
            per_run[name] = counted
    log(f"[13 serving] on {smi}: kernel launches per pipeline run, fused "
        f"and staged alike: {per_run}")

    # the ladder: widths 128, 32 and 8 each answer bitwise the 256-query
    # server's (router_hier's cluster size changes with the width)
    for name, p in points.items():
        srv = AsyncSeismicServer(index, p, max_batch=SERVE_MAX_BATCH,
                                 query_nnz=QUERY_NNZ, coalesce=False)
        futs = [srv.submit(c[q], v[q]) for q in range(160)]
        try:
            srv.start(warmup=False)      # batches of 128 and 32 queued
            for f in futs:
                f.wait(SERVE_TIMEOUT)
            futs.append(srv.submit(c[160], v[160]))      # then one of 1
            futs[-1].wait(SERVE_TIMEOUT)
        finally:
            srv.stop()
        subs = [(0, q, f) for q, f in enumerate(futs)]
        check_answers(f"ladder {name}", subs, {0: refs[name]})
        widths = {k: n for k, n in srv.telemetry_export()["counters"].items()
                  if k.startswith("launch_width_")}
        if set(widths) != {f"launch_width_{w}" for w in srv.launch_widths}:
            raise AssertionError(f"ladder {name}: widths {widths}")
        log(f"  ladder {name}: {widths}, 161 answers bitwise the 256-query "
            "server's")

    # the rate SeismicServer(max_batch=8) sustains one request at a time
    sync = SeismicServer(index, points["TUNED"], max_batch=ONLINE_BATCH)
    t0 = time.perf_counter()
    for i in range(SYNC_REQUESTS):
        sync.search(q256[i:i + 1]).ids.cpu()
    sync_rate = SYNC_REQUESTS / (time.perf_counter() - t0)
    rate = 2 * sync_rate
    units = serving_traffic(args.seed)
    log(f"  SeismicServer(max_batch={ONLINE_BATCH}) one request at a time: "
        f"{sync_rate:.1f} requests/s at TUNED; offered {rate:.1f} "
        f"requests/s from {SERVE_CLIENTS} clients (Poisson), "
        f"{SERVE_REQUESTS} requests a point: {Q_ONLINE} first occurrences "
        f"({SERVE_BURSTS} as bursts of 4), the rest repeats")

    # ---- the async server: TUNED, swap mid-traffic, flat
    obs = Observability.create(trace_capacity=4 * SERVE_REQUESTS,
                               stage_sample_every=STAGE_SAMPLE)
    auditors = {
        "TUNED": ShadowAuditor(index, points["TUNED"], obs.registry,
                               audit_sample_every=AUDIT_EVERY,
                               queue_bound=SERVE_REQUESTS,
                               window=SERVE_REQUESTS, z=AUDIT_Z),
        "flat": ShadowAuditor(index, points["flat"], MetricsRegistry(),
                              audit_sample_every=AUDIT_EVERY,
                              queue_bound=SERVE_REQUESTS,
                              window=SERVE_REQUESTS, z=AUDIT_Z)}
    srv = AsyncSeismicServer(
        index, points["TUNED"], max_batch=SERVE_MAX_BATCH,
        query_nnz=QUERY_NNZ, deadline_s=SERVE_DEADLINE,
        queue_bound=SERVE_QUEUE, admission="reject", cache_size=SERVE_CACHE,
        coalesce=True, obs=obs, auditor=auditors["TUNED"])
    for a in auditors.values():
        a.start()
    swap = {}

    def between():
        swap["tuned bytes"] = stage_bytes(obs.registry)
        t0 = time.perf_counter()
        swap["epoch"] = srv.swap_index(index, points["flat"],
                                       auditor=auditors["flat"])
        swap["seconds"] = time.perf_counter() - t0

    try:
        srv.start()
        runtime.reset_launches()
        subs, secs, sent = drive_clients(srv, units, c, v, rate, args.seed,
                                         halves=2, between=between)
    finally:
        srv.stop()
    for a in auditors.values():
        a.drain()
        a.close()
    counts = check_answers("async", subs, {0: refs["TUNED"], 1: refs["flat"]},
                           accept=refs["flat"])
    launches = dict(runtime.LAUNCHES)
    tel = srv.telemetry_export()
    batches = tel["counters"]["batches"]
    warm = len(srv.launch_widths) * 2            # the swap's warmup runs
    n_t = launches["router_hier"] // per_run["TUNED"]["router_hier"]
    n_f = launches["router_flat"] // per_run["flat"]["router_flat"] - warm
    for name in launches:
        want = n_t * per_run["TUNED"].get(name, 0) \
            + (n_f + warm) * per_run["flat"].get(name, 0)
        if launches[name] != want or n_t + n_f != batches:
            raise AssertionError(
                f"async: {name} launched {launches[name]} times, not "
                f"{n_t} x {per_run['TUNED'].get(name, 0)} + ({n_f} + "
                f"{warm}) x {per_run['flat'].get(name, 0)} ({batches} "
                "launches)")
    traces = obs.tracer.finished()
    for tr in traces:
        validate_trace(tr)
    log(f"  async (max_batch {SERVE_MAX_BATCH}, ladder {srv.launch_widths}"
        f", deadline {SERVE_DEADLINE * 1e3:.0f} ms): "
        + latency_line(subs, secs, sent))
    log(f"  every request done, bitwise the 256-query server's at its point "
        f"({counts['cached']} cached, {counts['coalesced']} coalesced; "
        f"{counts['after swap']} TUNED-part requests served after the swap); "
        f"swap_index to epoch {swap['epoch']} in {swap['seconds']:.3f} s "
        f"with warmup; {batches} launches ({n_t} TUNED, {n_f} flat) and "
        f"each kernel's count exact: {launches}")
    occ = {s["labels"]["width"]: round(s["value"], 3) for s in
           obs.registry.snapshot()["seismic_launch_width_occupancy"]
           ["samples"]}
    widths = {k: n for k, n in tel["counters"].items()
              if k.startswith("launch_width_")}
    coalesced = tel["counters"].get("coalesced", 0) \
        / tel["counters"]["requests"]
    log(f"  launches by width {widths}, occupancy {occ}; cache hit rate "
        f"{tel['cache']['hit_rate']:.3f}, coalesced share "
        f"{coalesced:.3f}; "
        f"launch spans: {launch_means(obs.tracer)}; {len(traces)} traces "
        "valid")
    log(f"  device accounting (fuse 2): TUNED {swap['tuned bytes']}; flat "
        f"{stage_bytes(obs.registry)}")

    # exports and the audit
    with start_exporter(obs.registry, obs.tracer,
                        quality=auditors["TUNED"].snapshot) as ex:
        import urllib.request
        with urllib.request.urlopen(ex.url + "/metrics", timeout=30) as r:
            scraped = parse_prometheus_text(r.read().decode())
    for text in (prometheus_text(obs.registry), None):
        parsed = scraped if text is None else parse_prometheus_text(text)
        flat_samples = {k: val for fam in parsed.values()
                        for k, val in fam["samples"].items()}
        want = registry_values(obs.registry)
        if any(flat_samples.get(k) != val for k, val in want.items()):
            bad = [k for k, val in want.items() if flat_samples.get(k) != val]
            raise AssertionError(f"exported samples differ: {bad[:5]}")
    log(f"  prometheus text and one scrape of {ex.url}/metrics: "
        f"{len(want)} samples equal to the registry's")
    recall = {"TUNED": kept["recall_tuned"], "flat": kept["recall_flat"]}
    for name, a in auditors.items():
        phase = 7 if name == "TUNED" else 6
        snap = a.snapshot()
        w = snap["window"]
        if snap["audits"] <= 0 or snap["errors"] or snap["dropped"]:
            raise AssertionError(f"audit {name}: {snap['audits']} audits, "
                                 f"{snap['errors']} errors, "
                                 f"{snap['dropped']} dropped")
        if sum(snap["loss"].values()) != snap["misses"]:
            raise AssertionError(f"audit {name}: funnel {snap['loss']} does "
                                 f"not sum to {snap['misses']} misses")
        inside = w["wilson_lo"] <= offline[name] <= w["wilson_hi"]
        log(f"  audit {name}: {snap['audits']} audits, live recall@10 "
            f"{w['live_recall']:.4f} Wilson (z {AUDIT_Z}) "
            f"[{w['wilson_lo']:.4f}, {w['wilson_hi']:.4f}] over "
            f"{w['trials']} trials; phase {phase}'s offline recall@10 over "
            f"the forward plane {offline[name]:.4f} "
            f"{'inside' if inside else 'OUTSIDE'} (over the float32 "
            f"collection {recall[name]:.4f}); funnel {snap['loss']} = "
            f"{snap['misses']} misses")
        if name == "TUNED" and not inside:
            raise AssertionError("audit TUNED: phase 7's offline recall "
                                 "lies outside the live recall's Wilson "
                                 "interval")

    # ---- mirror replicas, then one replica delayed
    delay = None
    for label in ("replicas", "replicas, one delayed"):
        robs = Observability.create(trace_capacity=2 * SERVE_REQUESTS,
                                    stage_sample_every=STAGE_SAMPLE)
        rs = ReplicaSeismicServer(
            index, points["TUNED"], n_replicas=REPLICAS, mode="mirror",
            replica_delay_s=None if delay is None
            else [delay] + [0.0] * (REPLICAS - 1),
            max_batch=SERVE_MAX_BATCH, query_nnz=QUERY_NNZ,
            deadline_s=SERVE_DEADLINE, queue_bound=SERVE_QUEUE,
            cache_size=SERVE_CACHE, coalesce=True, obs=robs)
        try:
            rs.start()
            runtime.reset_launches()
            CLUSTER_LAUNCHES.clear()
            subs, secs, sent = drive_clients(rs, units, c, v, rate,
                                             args.seed)
        finally:
            rs.stop()
        check_answers(label, subs, {0: refs["TUNED"]})
        counted = dict(runtime.LAUNCHES)
        rtel = rs.telemetry_export()
        n = rtel["counters"]["batches"]
        for name in counted:
            k = per_run["TUNED"].get(name, 0)
            if counted[name] != n * k:
                raise AssertionError(f"{label}: {name} launched "
                                     f"{counted[name]} times, not {n} x {k}")
        if sum(CLUSTER_LAUNCHES.values()) != counted["router_hier"]:
            raise AssertionError(f"{label}: router_hier's cluster counts "
                                 f"{dict(CLUSTER_LAUNCHES)} do not sum to "
                                 f"its {counted['router_hier']} launches")
        for tr in robs.tracer.finished():
            validate_trace(tr)
        for name in RETRIEVAL:
            launches[name] += counted[name]
        share = rs.balancer.snapshot()["dispatch_share"]
        log(f"  {label} ({REPLICAS} mirrors, delay "
            f"{0.0 if delay is None else delay * 1e3:.2f} ms on replica 0): "
            + latency_line(subs, secs, sent)
            + "; bitwise the async server's; "
            f"{n} launches, counts exact; dispatch share "
            f"{[round(x, 3) for x in share]}; launch spans: "
            f"{launch_means(robs.tracer)}")
        if delay is None:
            delay = DELAY_FACTOR * rtel["latency_s"]["launch"]["p50"]
        elif share[0] != min(share):
            raise AssertionError(f"{label}: the delayed replica's share "
                                 f"{share[0]:.3f} is not the smallest")
    log(f"  peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; phase 13 "
        f"in {time.perf_counter() - t_phase:.1f} s ({smi})")
    return {name: launches[name] for name in RETRIEVAL}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=1 << 20,
                    help="collection size (MS MARCO has 8,841,823)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import runtime

    # ---- 1. device
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_name_power()
    log(f"[1 device] {kind} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; TF32 off "
        "(matmul and cudnn)")

    # ---- 2. build the kernels
    t0 = time.perf_counter()
    reports = runtime.build_kernels()
    log(f"[2 build] {len(reports)} kernel sources built in "
        f"{time.perf_counter() - t0:.1f} s into {runtime.BUILD_DIR}")
    for name, text in reports.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "smem", "spill",
                                       "Compiling")):
                log(f"  {name}: {line.strip()}")
    from repro_torch.kernels.flash_attention.ops import wgmma_config
    for line in ptxas_lines("\n".join(reports.values())):
        log(f"  [redesigned] {line}")
    for d in (128, 64):
        log(f"  [redesigned] fa_wgmma_kernel<D {d}> as built: "
            + ", ".join(f"{k} {v}" for k, v in wgmma_config(d).items()))
    log("  [redesigned] gather_dot_cand dynamic shared memory (the q "
        f"bitmap): {-(-DIM // 32) * 4} B at d = {DIM}")
    from repro_torch.kernels import row_tiles
    from repro_torch.kernels.router_fused.ops import (flat_geometry,
                                                      hier_geometry)
    from repro_torch.kernels.summary_dot.ops import geometry
    for what, (ln, s) in (("flat router", (ROUTER_L, SUMMARY_S)),
                          ("superblock tier", (TUNED["cut"] * N_SUPER,
                                               SUPER_S)),
                          ("children", (TUNED["superblock_budget"] * FANOUT,
                                        SUMMARY_S))):
        g = geometry(ln, s, DIM)
        log(f"  [redesigned] summary_dot, {what} (L {ln}, S {s}): dynamic "
            f"shared memory {g['smem']} B (ring {g['stages']} x "
            f"{g['stage_bytes']} B of {g['tile_rows']} rows, bitmap "
            f"{-(-DIM // 32) * 4} B), {g['chunk_rows']} rows a block, "
            f"{g['rows_per_warp']} rows per warp")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for qn in (ONLINE_BATCH, Q_ONLINE, Q_BATCH):
        g = flat_geometry(qn, CUT, DIM, ROUTER_L // CUT, SUMMARY_S, DIM, sms)
        log(f"  [redesigned] router_flat (Q {qn}, cut {CUT}, nb "
            f"{ROUTER_L // CUT}, S {SUMMARY_S}): dynamic shared memory "
            f"{g['smem']} B (ring {g['stages']} x {g['stage_bytes']} B of "
            f"{g['tile_rows']} rows, 2 x {g['group']} query records of "
            f"{g['record_bytes']} B: up to {g['listed']} non-zeros, a group "
            f"table of {g['table_bytes']} B for up to "
            f"{g['union']} union coordinates), groups kernel "
            f"{g['groups_smem']} B, records kernel {g['records_smem']} B, "
            f"{g['grid']} persistent blocks, {g['scratch_words'] * 4} B of "
            "scratch; refine_round: static shared memory only")
    for qn in (ONLINE_BATCH, Q_ONLINE, Q_BATCH):
        g = hier_geometry(TUNED["cut"], N_SUPER, SUPER_S, SUMMARY_S, FANOUT,
                          TUNED["superblock_budget"], DIM,
                          row_tiles.cluster_size(qn, sms))
        log(f"  [redesigned] router_hier (Q {qn}, cut {TUNED['cut']}, ns "
            f"{N_SUPER}, S2 {SUPER_S}, S {SUMMARY_S}, fanout {FANOUT}): "
            f"dynamic shared memory {g['smem']} B (ring {g['stages']} "
            f"x {g['stage_bytes']} B: {g['tile_a']} superblock rows or "
            f"{g['segs_b']} superblocks' children), a cluster of "
            f"{g['cluster']} blocks per query on {sms} SMs")

    # ---- 3. kernels against plain, synthetic inputs at the slices' shapes
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    synthetic_phase(torch, dev, gen)
    fused_synthetic_phase(torch, dev, gen)
    log(f"[3 kernels vs plain] all variants within rtol={RTOL} atol={ATOL} "
        f"in {time.perf_counter() - t0:.1f} s")

    # ---- 4. run to run: collection and index made twice from one seed
    t0 = time.perf_counter()
    log(f"[4 run to run] {RUN_TO_RUN_DOCS} docs, seed {args.seed}:")
    run_to_run_phase(torch, dev, args.seed)
    log(f"  in {time.perf_counter() - t0:.1f} s")

    record, kept = retrieval_phases(torch, dev, args, runtime)

    # ---- 13. async micro-batching, mirror replicas, observability
    served = serving_phase(torch, dev, args, runtime, smi, kept)
    for rec in record:
        rec["launches"] += served[rec["name"]]
    # the servers and their registries' gauge callbacks form reference
    # cycles that hold the index's planes; phase 12 frees them after the
    # lift only if nothing else holds them
    gc.collect()

    # ---- 12. the mutation path on phase 7's index
    mutated = mutation_phase(torch, dev, args, runtime, smi,
                             kept.pop("index"), kept.pop("queries"))
    for rec in record:
        rec["launches"] += mutated[rec["name"]]
    gc.collect()                  # the index and the graph go here
    torch.cuda.empty_cache()

    # ---- 9. the LM path: flash_attention against plain, prefill, serving
    record.append(lm_phases(torch, dev, args.seed, runtime))
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": record}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
