#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py [--n-docs N] [--seed S]

Run from the repository root; needs one CUDA device and ``nvcc``. Phases:

1. device: name, count, ``nvidia-smi`` name and power limit; TF32 off for
   float32 matmuls and convolutions, so every reference is full float32;
   ``TUNED`` (below) is held to the knobs earlier slices served;
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
   gather_dot_cand, router_hier, refine_round) at ``TUNED``,
   ``SearchParams.from_tuned(CONFIG_TUNED, 0.95)`` (k 10, cut 8,
   block_budget 128, budget policy, superblock_budget 32, graph_degree 8,
   refine_rounds 2): the same two
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
   D 16 and 64, D 112 (bf16 causal, float32 ragged, a window of 64);
   its time at the prefill shape beside its bound, the plain version and
   ``scaled_dot_product_attention`` (which only this script calls), and
   once at 32768 tokens (prefill_32k of ``lm_shapes``) without the plain
   version; then at gemma3-27b's local layers ([1, 32 / 16, 8192, 128],
   window 1024; SDPA with a boolean band mask) and kimi-k2's heads ([1,
   64 / 8, 8192, 112]), each held to the plain version and timed beside
   its bound (live pairs only), the plain version and SDPA;
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
   peak device memory;
14. the recall-target tuner (run after phase 13, before phase 12, on
   phase 7's index and graph): 256 held-out queries (rows 256-511 of
   phase 5's 4096-query batch, so the collection's topics and disjoint
   from phase 7's 256) with their exact top-10 (``exact_topk`` on the
   card); ``sweep`` over ``default_grid(index, k=10, cut=8)`` plus
   ``CONFIG_TUNED``'s two modeled points at fuse levels 1 and 2 (every
   ``MeasuredPoint`` equal across them, asserted) and once staged with
   ``timings=True``; ``tune_and_attach`` at 0.90 and 0.95 (an infeasible
   target raises), the policies through ``validate_tuned_index``, each
   attached point at fuse 2 held to the plain path (use_kernel=False,
   fuse 0) on the held-out queries; ``from_tuned(index, 0.95)`` serves
   phase 7's 256 queries at fuse 2 through ``SeismicServer``. Printed: the frontier, the knobs and
   held-out recall and docs_evaluated at each target, phase 7's recall
   at the tuned point beside ``TUNED``'s, the sweep's seconds;
15. doc-sharded search and the paper's baselines (run after phase 12,
   before the LM phases), on phase 5's collection drawn again:
   ``build_sharded_index`` into 4 shards of 262,144 docs; at the flat
   ``SHAPES`` point and ``TUNED``'s route without refine (fuse 2), (i)
   every shard's pipeline, ``mask_shard_topk`` and a stable top-10 in one
   process, (ii) ``ReplicaSeismicServer(mode="shard")`` serving phase
   13's traffic with a ``swap_index`` from one point to the other in
   flight, (iii) ``make_distributed_search`` on 4 ranks (this script
   started again with ``--shard-rank``) sharing the card over gloo, each
   drawing the collection and building its own shard, the builds one
   after another (16 lists a build step; the main process frees its
   collection meanwhile). Asserted: every shard's kernel path held to
   its plain path (use_kernel=False, fuse 0); (i), (ii) and (iii)
   bitwise equal; every id valid and every score the exact inner product
   over the forward plane within ``1e-3 max(1, |ip|)``;
   ``docs_evaluated`` the shards' sum; every kernel of each route
   launched by each; the card's used memory (every process, sampled
   every 0.2 s) under 70 GiB at every stage. Then ``exact_search``
   (its ids ``exact_topk``'s except at ties, asserted), ``build_ivf``
   (4 sqrt(N) clusters, cap 256, 3 iterations, seed 0; two builds bitwise
   equal, asserted) and ``ivf_search`` at nprobe 2-32, and
   ``impact_search`` over the unsharded index's lists at a ladder of
   postings per list. Printed: build seconds and peak memory, recall@10
   beside the single index's, ms per batch, p50/p99, and a Table-1 block
   (recall@10, docs evaluated and ms a query for each baseline point and
   Seismic);
16. gemma3-27b (``configs/gemma3_27b.CONFIG`` at full width and depth:
   62 layers, 52 local with a window of 1024 and 10 global, bf16, drawn
   on the card from the seed, 52.9 GiB) prefills [1, 8192] with the
   kernel (62 flash_attention launches, 52 of them windowed, asserted)
   and on the plain path; logits compared; the 52 local layers run global
   must fall outside the logit bound (asserted), the 10 global layers
   windowed is printed; three timed runs; ``LMDecoder`` serves 8
   requests of 32 + 32 tokens; then a 6-layer cut (one LLLLLG period,
   full width) decodes 1,088 positions at batch 1 and its logits at
   positions 1,024-1,087, where the local layers' rings have wrapped, are
   held to its own forward's;
17. deepseek-v2-lite-16b (27 layers: MLA, a dense first layer, 26 MoE
   layers of 64 experts, top 6, 2 shared; full width and depth, 29.3
   GiB): prefill [1, 8192] launches no kernel (asserted; MLA and MoE have
   none in either package), two runs bitwise equal (asserted), the
   dropped share of (token, expert) assignments at capacity 960 printed;
   ``LMDecoder`` (capacity 1 at batch 8); decode (MLA's absorbed form)
   against forward at batch 2 over 64 positions with ``capacity_factor``
   64, so that neither drops, as the JAX package's own test: in bf16
   printed with the token-layers whose router chose other experts in
   the two paths (a rounding moves a top-6 of 64 now and then, and such
   a token takes another FFN), then in float32 at the same widths (the
   model drawn again, 58.5 GiB) held to the logit bound;
18. kimi-k2-1t-a32b at full width cut to 2 layers (the dense first layer
   and one MoE layer of 384 experts, top 8, 1 shared: 19.9B parameters,
   37.1 GiB; 61 layers are 1.9 TiB in bf16): prefill [1, 8192] with the
   kernel (2 launches at head dim 112, asserted) and on the plain path,
   logits compared; three timed runs; ``LMDecoder``.
Each of phases 16-18 holds the allocator's peak under 70 GiB.
19. Seismic's serving CLI, ``repro_torch.launch.serve.main`` (run after
   phase 18): at its defaults (8,192 docs, d 2048, 256 queries), at
   ``CLI_WIDE`` (262,144 docs, d 30522, 256 queries) and at ``CLI_WIDE``
   with 4 doc shards (``search_shards`` in this process), with launch
   counts set to 0 just before and read just after each. Asserted:
   summary_dot and gather_dot_cand launched, every id valid, the answer
   held to the plain path (use_kernel=False, fuse 0) on the same index
   and queries (ids equal except at ties, ``docs_evaluated`` equal).
   Printed: ms to answer, recall@10 beside the plain path's, docs
   evaluated;
20. llama3-8b training (``configs/llama3_8b.CONFIG`` at full width cut to
   4 layers, 1.92B parameters, bf16, remat "dots"): AdamW
   (``repro_torch.train``) on [4, 4096] batches (train_4k's sequence
   length) from ``lm_token_stream`` through ``PrefetchLoader``, in 4
   microbatches. Asserted: ``loss_fn(use_kernel=True)`` raises under
   autograd; every loss finite; on one repeated batch the loss after 5
   steps below step 0's; 2 steps, ``CheckpointManager.save_async``, a
   restore into freshly drawn parameters and 2 more steps bitwise equal
   to 4 uninterrupted steps (parameters; moments by a fingerprint of
   their bits); the allocator's peak under 70 GiB. Printed: ms a step
   (steps 1-3 after a warm step), tokens/s, model FLOP/s (6 x parameters
   x tokens / step time) as a share of the bf16 dense peak, the
   checkpoint's size and save / load seconds;
21. deepseek-v2-lite-16b training at full width cut to 2 layers (the
   dense layer and one MoE layer: 64 experts, top 6, 2 shared, MLA;
   1.09B parameters, bf16): two steps on [2, 4096] in 2 microbatches.
   Asserted: finite losses and aux, the aux loss's gradient reaches the
   router, the router's first moment non-zero, the peak under 70 GiB.
   Printed: ms a step. Then llama3-8b and deepseek-v2-lite-16b REDUCED
   in float32 train 3 steps on the card and on the CPU from the same
   parameters and batches, held to the bounds below;
22. the recsys family at the full CONFIGs of ``configs/fm.py``,
   ``wide_deep.py``, ``sasrec.py`` and ``bst.py`` (float32), through
   ``get_bundle`` and ``make_batch``, every ``RECSYS_SHAPES`` cell:
   train_batch (65,536) 3 AdamW steps (lr 1e-3) on one repeated batch,
   twice from one seed; serve_p99 (512) against the port on the CPU with
   the same parameters; serve_bulk (262,144) examples/s; retrieval_cand
   (1,000,448 candidates; bst 65,536 at a time) latency, its first 4,096
   candidates' scores and top-10 against the CPU, fm's and sasrec's
   ``[C, D] @ [D]`` shortcut against their full scoring (``forward``,
   ``serve_step``) of all candidates. Then the SASRec -> Seismic bridge
   (``examples/recsys_retrieval.py``) on sasrec's 1,000,448-row item
   table: [relu(x); relu(-x)] sparsified to 16 non-zeros, ``build_index``
   with the example's knobs and lam 20,000, the states of 256 histories
   searched by ``search_batch`` at the port's defaults with launch counts
   set to 0 just before and read just after (summary_dot and
   gather_dot_cand asserted), held to the plain path (ids except at ties,
   ``docs_evaluated`` equal), the top-10 overlap with brute force over the
   dense table printed. Asserted besides: losses finite and the loss
   after the steps below step 0's, the two runs' parameters bitwise
   equal, every allocator peak under 70 GiB;
23. gin-tu at its CONFIG (5 layers, d_hidden 64) over every
   ``GNN_SHAPES`` cell through ``make_batch``: 3 AdamW steps (lr 3e-5)
   twice from one seed (bitwise equal, the loss falls); full_graph_sm and
   molecule held to the CPU (step 0's gradients, 3 steps' losses and
   parameters); minibatch_lg (170,496 padded nodes, 168,960 edges, d_feat
   602); ogb_products (2,449,408 nodes, 61,859,328 edges) one forward
   without autograd, its aggregate at 4,096 sampled nodes held to float64
   sums on the host, then the steps; then ``random_graph`` at
   minibatch_lg's 232,965 nodes with a tenth of its edges (11,461,589,
   mean in-degree 49, above the fanout of 15), ``CSRGraph`` and
   ``sample_subgraph`` (1,024 seeds, fanout (15, 10)), and 3 steps twice
   on that batch. Printed: ms a step, peak GiB, the host's seconds.

The index and query widths come from ``configs/seismic_msmarco``
(``CONFIG_HIER`` and ``SHAPES``); the 0.95 operating point ``TUNED`` is
``SearchParams.from_tuned(CONFIG_TUNED, 0.95)``. The servers' gauge
callbacks hold their owners weakly, so a deleted server frees its index
by reference counting (no collector call between phases 13 and 12).

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
sequence, is held to it and has to fail (phase 10). The same bound holds
gemma3-27b's and kimi-k2's kernel paths to their plain paths and the
decodes of phases 16 and 17 to their forwards: gemma3-27b's 62 layers
add up to about ``sqrt(620) * 2**-9 ~ 4.9 %``, inside it; its local
layers run global has to fail it. deepseek's two prefills are compared
bitwise: no sum of the MoE runs on atomics.

Training, the card against the CPU (float32, TF32 off): losses within
``rtol`` 1e-4; parameters after n steps 99.9 % within ``5e-3 * lr * n``
and all within ``lr * n / 4``. The two run the same float32 sums in
another order, and AdamW's normalised step (about ``lr`` an element) can
flip where a gradient is near zero; the CPU tests hold the port to the
JAX package with the same bounds (``tests/test_torch_train.py``). For
gin-tu (phase 23) the leaves are small (molecule's second layer has 4,096
weights, where 5 flipped elements pass 0.1 %), so step 0's gradients
are held instead, per leaf within 2e-5 of its largest, beside the
losses and the ``lr * n / 4`` bound.

The recsys and GNN families (phases 22-23), float32, TF32 off: the card
against the CPU ``allclose(rtol=1e-4, atol=1e-4)`` (the longest dot is
wide-deep's first layer, 1,293 terms: two orders of a float32 sum differ
by far less); fm's and sasrec's shortcut against their full scoring
within ``atol`` 1e-5 (the same products, the pair term's sums in another
order); top-10 ids equal except at ties; gin's aggregate against float64
host sums within ``n * 2**-24 * sum|terms|`` for a node of in-degree n
(float32 sums of n terms in any order); repeated runs bitwise: no atomic
add on these paths (embedding lookups sort their ids in the backward,
gin's sums run over edges sorted by destination and, backward, by
source).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch.configs.seismic_msmarco import (CONFIG_HIER,
                                                     CONFIG_TUNED, SHAPES)
    from repro_torch.retrieval.params import SearchParams as _Params
    from repro_torch.tune.policy import knobs_from_params
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
# CONFIG_TUNED's operating point at recall target 0.95: the modeled
# TunedPolicy the tuner's frontier code picks (configs/seismic_msmarco),
# resolved as a server resolves a tuned index's; phase 1 holds it to the
# knobs earlier slices served as a literal
TUNED = knobs_from_params(_Params.from_tuned(CONFIG_TUNED, 0.95))
TUNED_LITERAL = dict(k=10, cut=8, block_budget=128, policy="budget",
                     superblock_fanout=FANOUT, superblock_budget=32,
                     graph_degree=8, refine_rounds=2)
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
# phase 14: the tuner's sweep over 256 held-out queries (rows 256-511 of
# phase 5's 4096-query batch) at two recall targets
TUNE_TARGETS = (0.90, 0.95)
# phase 15: phase 5's collection in 4 doc shards; the paper's baselines
# as benchmarks/table1_tradeoff.py sets them (IVF: 4 sqrt(N) clusters of
# at most 256 docs, 3 Lloyd iterations)
N_SHARDS = 4
SHARD_LIST_CHUNK = 16          # lists a build step (results do not change;
                               # a smaller step, less build scratch)
CARD_LIMIT_GIB = 70.0          # phase 15's budget for the card's used memory
PLAIN_ROWS = 32                # queries a plain-path call in phase 15 (its
                               # scratch grows with the batch)
IVF_CAP, IVF_ITERS, IVF_NPROBE = 256, 3, (2, 4, 8, 16, 32)
IMPACT_POSTINGS = (64, 256, 1024, 6000)
SCORE_TOL = 1e-3               # |score - ip| <= 1e-3 max(1, |ip|)
RANK_TIMEOUT = 600.0
ATTN_F32_TOL = 2e-5            # flash_attention, float32: rtol = atol
LM_REL_L2 = 2 ** -4            # LM logits, two bf16 paths
LOGIT_ROWS = 256               # positions a chunk of the logit comparison
# phases 16-18: gemma3-27b, deepseek-v2-lite-16b and kimi-k2-1t-a32b at
# their published widths; gemma's ring checked on one LLLLLG period (6
# layers) over 1,088 positions (its window is 1,024); kimi cut to its
# dense layer and one MoE layer; deepseek's decode against its forward
# at batch 2 over 64 positions with capacity_factor 64 (no drops, as the
# JAX package's own check); every model's allocator peak under 70 GiB
GEMMA_RING_LAYERS, GEMMA_RING_POS = 6, 1088
KIMI_LAYERS = 2
MLA_CHECK_BATCH, MLA_CHECK_POS, MLA_CHECK_CF = 2, 64, 64.0
MODEL_PEAK_GIB = 70.0
# phase 9's two model shapes beside llama3-8b's: gemma3-27b's local
# layers (Hq 32, Hkv 16, D 128, window 1024) and kimi-k2's (Hq 64, Hkv 8,
# D 112), at 8192 tokens; the plain version runs 16 q heads a call
GEMMA_ATTN = (1, 32, 16, LM_SEQ, 128, 1024)
KIMI_ATTN = (1, 64, 8, LM_SEQ, 112, None)
PLAIN_HEADS = 16
# phase 19: Seismic's serving CLI at its defaults and at MS MARCO's vocabulary
# over 262,144 docs (alone and in 4 doc shards)
CLI_WIDE = ["--n-docs", "262144", "--dim", str(DIM), "--queries", "256"]
# phases 20-21: llama3-8b at full width cut to 4 layers (32 with AdamW's
# state need about 128 GB) on train_4k's sequence length, 4 x 4096 tokens a
# step in 4 microbatches; deepseek-v2-lite-16b on [2, 4096]
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 4, 4, 4096, 4
TRAIN_LR = 1e-3
# phases 22-23: the recsys and GNN families at their configs' full widths
# (configs/fm.py, wide_deep.py, sasrec.py, bst.py, gin_tu.py) over every
# cell of RECSYS_SHAPES and GNN_SHAPES; 3 AdamW steps a training cell
RECSYS_ARCHS = ("fm", "wide-deep", "sasrec", "bst")
FAMILY_LR, FAMILY_STEPS = 1e-3, 3
# GIN sums neighbours and readouts without a norm, so its logits grow with
# degree and graph size: at lr 1e-3 AdamW's first step took molecule's loss
# from 7.1 to 52.8 on the card (the JAX package's smoke checks finiteness
# only); at 3e-5 each cell's loss falls step by step
GNN_LR = 3e-5
FAMILY_RTOL = FAMILY_ATOL = 1e-4    # the card against the CPU, float32
FAMILY_SHORTCUT_ATOL = 1e-5         # fm's / sasrec's shortcut vs full scoring
CPU_SLICE = 4096                    # retrieval candidates held to the CPU
GNN_GRAD_ATOL = 2e-5                # of a leaf's largest gradient
GNN_CHECK_NODES = 4096              # ogb_products' aggregate vs the host
GRAPH_EDGE_CUT = 10                 # the sampled graph: a tenth of the edges
# the SASRec -> Seismic bridge (examples/recsys_retrieval.py): its knobs,
# lam raised with the item count (16 of 100 coordinates a row: ~160,000
# postings a list, of which 20,000 keep the example's share)
BRIDGE_USERS, BRIDGE_NNZ, BRIDGE_LAM = 256, 16, 20000


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
        ("D 112", 1, 8, 1, 1000, 112, bf16, True, None),
        ("D 112 f32 ragged", 2, 4, 2, 200, 112, f32, True, None),
        ("D 112 window 64", 1, 8, 2, 1000, 112, bf16, True, 64),
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


def attention_bound(b, hq, hkv, s, d, window=None):
    """flash_attention's least time at [B, Hq, S, D] bf16, causal, over
    Hkv kv heads -> (ms, "operations" or "bytes", TFLOP, MB, live (q, k)
    pairs a head): Q K^T and P V over the live pairs only (``sum_q
    min(q + 1, window)``), against q, k, v and o read or written once."""
    pairs = s * (s + 1) / 2 if window is None else \
        sum(min(q + 1, window) for q in range(s))
    ops = 4 * d * hq * b * pairs
    nbytes = 2 * b * s * d * 2 * (hq + hkv)
    t_ops, t_bytes = ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, ops / 1e12, nbytes / 1e6, pairs


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
        bms, by, tflop, mb, _ = attention_bound(b, hq, hkv, s, d)
        log(f"[9 flash_attention] [{b}, {hq}, {s}, {d}] bf16 causal, Hkv "
            f"{hkv}: {ms:.4f} ms (bound {bms:.4f} ms by {by}: "
            f"{tflop:.3f} TFLOP at 989 TFLOP/s, {mb:.1f} MB "
            f"at 3.35 TB/s; {bms / ms:.1%} of it, {tflop / ms * 1e3:.1f} "
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


def flash_model_shape(torch, dev, gen, bench, label, shape) -> dict:
    """Phase 9 at one more model's shape ``(B, Hq, Hkv, S, D, window)``,
    bf16 causal: the kernel against its plain version (PLAIN_HEADS q
    heads a call), its time beside the bound, the plain version's time
    and ``scaled_dot_product_attention``'s (``enable_gqa``; a window as
    an explicit boolean band mask, SDPA having no window argument). The
    bound counts the live (q, k) pairs only: ``4 Hq D sum_q min(q + 1,
    window)`` operations. Returns the kernel's record (launches filled
    by the model's phase)."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_ref,
                                                         route)
    b, hq, hkv, s, d, window = shape
    g = hq // hkv
    q, k, v = attention_inputs(torch, dev, gen, b, hq, hkv, s, d,
                               torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kern():
        return flash_attention(q, k, v, causal=True, window=window)

    def plain(row=False):
        outs = []
        for h0 in range(0, hq, PLAIN_HEADS):
            h1 = min(h0 + PLAIN_HEADS, hq)
            kh, vh = (x[:, h0 // g:(h1 - 1) // g + 1] for x in (k, v))
            qh = q[:, h0:h1]
            if row:      # the tolerance's row term: plain on |v|, float32
                qh, kh, vh = qh.float(), kh.float(), vh.float().abs()
            outs.append(flash_attention_ref(qh, kh, vh, causal=True,
                                            window=window))
        return torch.cat(outs, dim=1)

    if window is None:
        def lib():
            return sdpa(q, k, v, is_causal=True, enable_gqa=True)
    else:
        pos = torch.arange(s, device=dev)
        band = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] > pos[:, None] - window)

        def lib():
            return sdpa(q, k, v, attn_mask=band, enable_gqa=True)

    got = kern()
    err, worst = compare_attention(torch, f"flash_attention {label}", got,
                                   plain(), plain(row=True))
    ms, lib_ms = bench.ms(kern), bench.ms(lib)
    plain_ms = bench.ms(plain, iters=2, warmup=1)
    gap = float((got.float() - lib().float()).abs().max())
    bms, by, tflop, mb, pairs = attention_bound(b, hq, hkv, s, d, window)
    kind = route(torch.bfloat16, d)[0]
    log(f"[9 flash_attention] {label} [{b}, {hq}, {s}, {d}] bf16 causal, "
        f"Hkv {hkv}, window {window}, the {kind} kernel: max abs err "
        f"{err:.3e} (worst element at {worst:.3f} of its tolerance); "
        f"{ms:.4f} ms (bound {bms:.4f} ms by {by}: {tflop:.3f} TFLOP "
        f"over {pairs:.0f} live (q, k) pairs a head at 989 TFLOP/s, "
        f"{mb:.1f} MB at 3.35 TB/s; {bms / ms:.1%} of it, "
        f"{tflop / ms * 1e3:.1f} TFLOP/s), plain {plain_ms:.3f} ms "
        f"({PLAIN_HEADS} q heads a call), scaled_dot_product_attention "
        f"{lib_ms:.4f} ms (max abs gap to the kernel {gap:.3e})")
    src, rep = SOURCES["flash_attention"]
    return dict(name=f"flash_attention ({label})", route="cuda", source=src,
                replaces=rep, launches=None, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)


def logit_distance(torch, label, got, want) -> tuple[float, str]:
    """Two bf16 paths' logits: finite and of one shape -> (relative L2
    distance, text with the max abs gap, the top-1 agreement and the
    ``want`` path's top-1/top-2 gap where the argmax flips). Compared
    LOGIT_ROWS positions at a time in float32, so no [S, V] float32 copy
    of either exists (gemma3-27b's are 8.6 GB)."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shapes {tuple(got.shape)} and "
                             f"{tuple(want.shape)}")
    v = want.shape[-1]
    gr, wr = got.reshape(-1, v), want.reshape(-1, v)
    sq_d = sq_w = 0.0
    max_d = max_w = 0.0
    flips, gaps = [], []
    for r0 in range(0, wr.shape[0], LOGIT_ROWS):
        g, w = gr[r0:r0 + LOGIT_ROWS].float(), wr[r0:r0 + LOGIT_ROWS].float()
        if not (bool(torch.isfinite(g).all())
                and bool(torch.isfinite(w).all())):
            raise AssertionError(f"{label}: non-finite logits")
        diff = g - w
        sq_d += float(diff.double().square().sum())
        sq_w += float(w.double().square().sum())
        max_d = max(max_d, float(diff.abs().max()))
        max_w = max(max_w, float(w.abs().max()))
        flips.append(g.argmax(-1) != w.argmax(-1))
        top2 = w.topk(2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        del g, w, diff
    flip, gap = torch.cat(flips), torch.cat(gaps)
    rel = (sq_d / sq_w) ** 0.5
    at_flip = (f"median {float(gap[flip].median()):.4f}, max "
               f"{float(gap[flip].max()):.4f}" if bool(flip.any())
               else "no flips")
    text = (f"relative L2 {rel:.3e}, max abs {max_d:.3e} (logits' max abs "
            f"{max_w:.2f}), top-1 agreement "
            f"{1 - float(flip.float().mean()):.4f}; top-1/top-2 gap of the "
            f"reference where the argmax flips: {at_flip} (median over all "
            f"positions {float(gap.median()):.4f})")
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


def lm_phases(torch, dev, seed, runtime) -> list[dict]:
    """Phases 9-11: flash_attention against plain and timed; llama3-8b
    prefill at [1, 8192] with the kernel against the plain chunked path;
    ``LMDecoder`` serving 8 requests, its decode logits against the
    forward's. Returns flash_attention's records: llama3-8b's shape, then
    gemma3-27b's and kimi-k2's (their launches left to phases 16, 18)."""
    from repro_torch.configs import llama3_8b
    from repro_torch.models.transformer import attention, lm
    from repro_torch.serve import LMDecoder
    t_lm = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    bench = Bench(torch, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    rec = flash_phase(torch, dev, gen, bench)
    torch.cuda.empty_cache()
    shapes = [flash_model_shape(torch, dev, gen, bench, label, shape)
              for label, shape in (("gemma3-27b prefill", GEMMA_ATTN),
                                   ("kimi-k2 prefill", KIMI_ATTN))]
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
    return [rec, *shapes]


def draw_model(torch, dev, lm, cfg, seed, label):
    """``lm.init_params`` of ``cfg`` on the card from the seed, its size
    printed; the allocator's peak statistics reset first."""
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"[{label}] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, vocab {cfg.vocab}, "
        f"{cfg.dtype}: drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s; {n} parameters "
        f"({cfg.param_count()} by the config, {cfg.active_param_count()} "
        f"active a token), {nbytes} bytes ({nbytes / 2**30:.2f} GiB)")
    return params


def check_peak(torch, dev, label: str) -> float:
    """The allocator's peak since the last reset, in GiB; raises at or
    past MODEL_PEAK_GIB."""
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if peak >= MODEL_PEAK_GIB:
        raise AssertionError(f"{label}: the allocator's peak {peak:.2f} GiB "
                             f"is not under {MODEL_PEAK_GIB} GiB")
    return peak


@contextlib.contextmanager
def attention_calls(attention):
    """Records (window, head dim) of each flash_attention call the model
    makes (the wrapper still counts its own launches)."""
    kernel = attention.flash_attention
    seen = []

    def spy(q, k, v, **kw):
        seen.append((kw.get("window"), q.shape[-1]))
        return kernel(q, k, v, **kw)

    attention.flash_attention = spy
    try:
        yield seen
    finally:
        attention.flash_attention = kernel


@contextlib.contextmanager
def moe_assignments(torch, ffn):
    """Counts, on the card, the (token, k) assignments of each MoE call
    and those its capacity keeps: yields a list of (assignments, kept
    tensor, capacity, the expert ids [T, k])."""
    real = ffn._dispatch_compute
    seen = []

    def spy(x, idx, w, w1, w3, w2, capacity):
        flat = idx.reshape(-1)
        counts = torch.zeros(w1.shape[0], dtype=torch.int64,
                             device=idx.device).index_add_(
            0, flat, torch.ones_like(flat))
        seen.append((flat.numel(), counts.clamp(max=capacity).sum(),
                     capacity, idx))
        return real(x, idx, w, w1, w3, w2, capacity)

    ffn._dispatch_compute = spy
    try:
        yield seen
    finally:
        ffn._dispatch_compute = real


def dropped_text(seen) -> str:
    total = sum(n for n, _, _, _ in seen)
    kept = sum(int(k) for _, k, _, _ in seen)
    caps = sorted({c for _, _, c, _ in seen})
    return (f"{total - kept} of {total} (token, expert) assignments dropped "
            f"({(total - kept) / max(total, 1):.4f}) at capacity "
            f"{', '.join(map(str, caps))} over {len(seen)} MoE calls")


def routing_flips(seen, n_moe, batch, seq) -> tuple[int, int]:
    """``moe_assignments`` of one forward over [batch, seq] tokens (its
    first ``n_moe`` calls) then ``seq`` decode steps of the same tokens
    -> (token-layers whose decode step chose another set of experts than
    the forward, token-layers)."""
    fwd = [s[3].sort(dim=1).values for s in seen[:n_moe]]
    dec = [s[3].sort(dim=1).values for s in seen[n_moe:]]
    flips = 0
    for i in range(seq):
        for layer in range(n_moe):
            rows = fwd[layer].view(batch, seq, -1)[:, i]
            flips += int((rows != dec[i * n_moe + layer]).any(1).sum())
    return flips, batch * seq * n_moe


def decode_vs_forward(torch, dev, gen, lm, ffn, params, cfg, label):
    """MLA_CHECK_BATCH sequences of MLA_CHECK_POS tokens: decode logits
    against ``forward(use_kernel=True)``'s -> (relative L2, text), the
    text with the token-layers routed differently."""
    toks = torch.randint(0, cfg.vocab, (MLA_CHECK_BATCH, MLA_CHECK_POS),
                         generator=gen, device=dev)
    with moe_assignments(torch, ffn) as seen:
        full, _ = lm.forward(params, toks, cfg, use_kernel=True)
        cache = lm.init_cache(cfg, MLA_CHECK_BATCH, MLA_CHECK_POS,
                              device=dev)
        dec = torch.stack([lm.decode_step(params, cache, toks[:, i:i + 1],
                                          i, cfg)[0]
                           for i in range(MLA_CHECK_POS)], dim=1)
    rel, text = logit_distance(torch, label, dec, full)
    flips, n = routing_flips(seen, lm.n_scan_layers(cfg),
                             MLA_CHECK_BATCH, MLA_CHECK_POS)
    return rel, (f"{text}; {flips} of {n} token-layers routed to another "
                 f"set of experts than the forward's; {dropped_text(seen)}")


def timed_prefills(torch, lm, params, tokens, cfg,
                   runs=3) -> tuple[str, list[float]]:
    """``runs`` timed prefills: (their line, the ms of each)."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        lm.forward(params, tokens, cfg, use_kernel=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return ", ".join(f"{t:.1f} ms ({tokens.numel() / t * 1e3:.0f} tokens/s)"
                     for t in times), times


def router_share(torch, dev, ffn, cfg, prefill_ms: list[float]) -> str:
    """The MoE router's float64 product (``ffn.router_logits``) at the
    prefill's [LM_SEQ, d_model] x [d_model, n_experts]: CUDA-event mean
    of 5 runs after a warm one, L2 flushed, and its share of the median
    prefill over the config's MoE layers."""
    import numpy as np
    x = torch.randn(LM_SEQ, cfg.d_model, device=dev,
                    dtype=getattr(torch, cfg.dtype))
    w = torch.randn(cfg.d_model, cfg.n_experts, device=dev)
    ms = Bench(torch, dev).ms(lambda: ffn.router_logits(w, x), iters=5,
                              warmup=1)
    n_moe = cfg.n_layers - cfg.n_dense_layers
    flop = 2 * LM_SEQ * cfg.d_model * cfg.n_experts
    share = n_moe * ms / float(np.median(prefill_ms))
    del x, w
    torch.cuda.empty_cache()
    return (f"the router's float64 product [{LM_SEQ}, {cfg.d_model}] x "
            f"[{cfg.d_model}, {cfg.n_experts}] ({flop / 1e9:.1f} GFLOP) "
            f"{ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s) x {n_moe} MoE "
            f"layers = {n_moe * ms:.2f} ms, {share:.4f} of the median "
            f"prefill")


def serve_model(torch, dev, gen, LMDecoder, params, cfg, label,
                runs=2) -> None:
    """``LMDecoder(batch=8)``: 8 requests of 32-token prompts, 32 greedy
    tokens each, ``runs`` times; prints ms a decode step."""
    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, PROMPT_LEN),
                            generator=gen, device=dev)
    steps = PROMPT_LEN + NEW_TOKENS
    dec = LMDecoder(params, cfg, batch=SERVE_BATCH, max_seq=steps)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        toks = dec.generate(prompts, NEW_TOKENS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if toks.shape != (SERVE_BATCH, steps) or not bool(
            torch.equal(toks[:, :PROMPT_LEN], prompts.to(torch.int32))):
        raise AssertionError(f"{label} LMDecoder: tokens of the wrong shape "
                             "or prompts not kept")
    log(f"  LMDecoder(batch={SERVE_BATCH}, max_seq={steps}): "
        f"{SERVE_BATCH} requests of {PROMPT_LEN}-token prompts, "
        f"{NEW_TOKENS} greedy tokens each ({steps} decode steps): "
        + ", ".join(f"{t:.0f} ms ({t / steps:.2f} ms per decode step)"
                    for t in times))


def gemma_phase(torch, dev, seed, runtime, gen) -> int:
    """Phase 16: gemma3-27b at full width and depth: prefill [1, 8192]
    with the kernel (62 launches, the 52 local layers windowed) against
    the plain path; two wrong paths; ``LMDecoder``; then a 6-layer cut
    (one LLLLLG period) decodes 1,088 positions and its logits past the
    window are held to its own forward's. Returns the prefill's
    flash_attention launches."""
    from repro_torch.configs import gemma3_27b
    from repro_torch.models.transformer import attention, lm
    from repro_torch.serve import LMDecoder
    t_phase = time.perf_counter()
    cfg = gemma3_27b.CONFIG
    wins = lm.layer_windows(cfg)
    n_local = int((wins > 0).sum())
    params = draw_model(torch, dev, lm, cfg, seed, "16 gemma3-27b")
    tokens = torch.randint(0, cfg.vocab, (1, LM_SEQ), generator=gen,
                           device=dev)
    torch.cuda.synchronize()
    runtime.reset_launches()
    with attention_calls(attention) as seen:
        logits_k, _ = lm.forward(params, tokens, cfg, use_kernel=True)
        torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    windowed = sum(w == cfg.local_window for w, _ in seen)
    log(f"  launches of one forward [1, {LM_SEQ}], use_kernel=True: "
        f"{launches}; flash_attention calls with window "
        f"{cfg.local_window}: {windowed}, without: "
        f"{sum(w is None for w, _ in seen)}")
    if launches["flash_attention"] != cfg.n_layers or len(seen) != \
            cfg.n_layers or windowed != n_local:
        raise AssertionError(
            f"gemma3-27b prefill: {launches['flash_attention']} "
            f"flash_attention launches ({windowed} windowed), not "
            f"{cfg.n_layers} ({n_local})")
    t0 = time.perf_counter()
    logits_p, _ = lm.forward(params, tokens, cfg, use_kernel=False)
    torch.cuda.synchronize()
    log(f"  logits {tuple(logits_k.shape)} {logits_k.dtype}, kernel path vs "
        f"plain path ({time.perf_counter() - t0:.2f} s): "
        + lm_agreement(torch, "gemma3-27b prefill kernel vs plain",
                       logits_k, logits_p))
    del logits_k
    # the bound must reject the local layers run global; the global
    # layers windowed is printed
    for label, override, must_fail in (
            ("local layers global", dict(window=None), True),
            ("global layers windowed", dict(window=cfg.local_window),
             False)):
        with wrong_attention(attention, **override):
            logits_w, _ = lm.forward(params, tokens, cfg, use_kernel=True)
        rel, text = logit_distance(torch, label, logits_w, logits_p)
        del logits_w
        log(f"  known-wrong path, {label}, vs plain path: {text}")
        if must_fail and rel <= LM_REL_L2:
            raise AssertionError(f"the logit bound {LM_REL_L2} does not "
                                 f"reject gemma3-27b with the {label}")
    del logits_p
    log(f"  prefill [1, {LM_SEQ}], use_kernel=True, 3 runs: "
        + timed_prefills(torch, lm, params, tokens, cfg)[0])
    serve_model(torch, dev, gen, LMDecoder, params, cfg, "gemma3-27b")
    peak = check_peak(torch, dev, "gemma3-27b")
    log(f"  peak device memory {peak:.2f} GiB")
    del params
    torch.cuda.empty_cache()

    # ---- the ring wraps: one LLLLLG period at full width
    cut = dataclasses.replace(cfg, n_layers=GEMMA_RING_LAYERS)
    params = draw_model(torch, dev, lm, cut, seed,
                        f"16 gemma3-27b, {GEMMA_RING_LAYERS}-layer cut")
    toks = torch.randint(0, cfg.vocab, (1, GEMMA_RING_POS), generator=gen,
                         device=dev)
    fwd, _ = lm.forward(params, toks, cut, use_kernel=True)
    cache = lm.init_cache(cut, 1, GEMMA_RING_POS, device=dev)
    w = cfg.local_window
    tail = []
    t0 = time.perf_counter()
    for i in range(GEMMA_RING_POS):
        logits, cache = lm.decode_step(params, cache, toks[:, i:i + 1], i,
                                       cut)
        if i >= w:
            tail.append(logits)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"  {GEMMA_RING_POS} decode steps at batch 1 "
        f"({dt * 1e3 / GEMMA_RING_POS:.2f} ms a step; local caches of {tuple(cache['k_local'].shape)}, the "
        f"ring wraps at position {w}); decode logits at positions {w}-"
        f"{GEMMA_RING_POS - 1} vs forward(use_kernel=True): "
        + lm_agreement(torch, "gemma3-27b ring decode vs forward",
                       torch.stack(tail, dim=1), fwd[:, w:]))
    peak = check_peak(torch, dev, "gemma3-27b cut")
    log(f"  peak device memory {peak:.2f} GiB; phase 16 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    del params, cache, fwd, tail
    torch.cuda.empty_cache()
    return launches["flash_attention"]


def deepseek_phase(torch, dev, seed, runtime, gen) -> None:
    """Phase 17: deepseek-v2-lite-16b at full width and depth: prefill [1,
    8192] (no kernel launch: MLA has none) run twice, bitwise equal, with
    the MoE's dropped share; ``LMDecoder``; decode against forward at
    capacity_factor 64, in bf16 (printed) and in float32 (held to the
    logit bound)."""
    from repro_torch.configs import deepseek_v2_lite_16b
    from repro_torch.models.transformer import ffn, lm
    from repro_torch.serve import LMDecoder
    t_phase = time.perf_counter()
    cfg = deepseek_v2_lite_16b.CONFIG
    params = draw_model(torch, dev, lm, cfg, seed, "17 deepseek-v2-lite-16b")
    tokens = torch.randint(0, cfg.vocab, (1, LM_SEQ), generator=gen,
                           device=dev)
    torch.cuda.synchronize()
    runtime.reset_launches()
    with moe_assignments(torch, ffn) as seen:
        la, aux_a = lm.forward(params, tokens, cfg, use_kernel=True)
        torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"deepseek prefill launched {launches}: MLA "
                             "and MoE have no kernel")
    t0 = time.perf_counter()
    lb, aux_b = lm.forward(params, tokens, cfg, use_kernel=True)
    torch.cuda.synchronize()
    t_run = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(la, lb) and torch.equal(aux_a, aux_b)):
        raise AssertionError("deepseek prefill: two runs differ")
    if la.shape != (1, LM_SEQ, cfg.vocab) or not bool(
            torch.isfinite(la).all()):
        raise AssertionError("deepseek prefill: logits not finite or of "
                             "the wrong shape")
    log(f"  prefill [1, {LM_SEQ}]: launches {launches}; two runs bitwise "
        f"equal (logits {tuple(la.shape)} {la.dtype}, aux "
        f"{float(aux_a):.4f}); the second {t_run:.1f} ms "
        f"({LM_SEQ / t_run * 1e3:.0f} tokens/s); " + dropped_text(seen))
    del la, lb
    text, times = timed_prefills(torch, lm, params, tokens, cfg)
    log(f"  prefill [1, {LM_SEQ}], 3 runs: {text}; "
        + router_share(torch, dev, ffn, cfg, times))
    with moe_assignments(torch, ffn) as seen:
        serve_model(torch, dev, gen, LMDecoder, params, cfg,
                    "deepseek", runs=1)
    log("  the decoder's MoE: " + dropped_text(seen))
    serve_model(torch, dev, gen, LMDecoder, params, cfg, "deepseek",
                runs=1)
    # decode (MLA's absorbed form) against forward: in bf16 a rounding
    # moves a router's top-6 of 64 now and then, and a token routed to
    # another expert set takes another FFN (printed); the bound is held in
    # float32 at the same widths, where such flips are rare
    chk = dataclasses.replace(cfg, capacity_factor=MLA_CHECK_CF)
    _, text = decode_vs_forward(torch, dev, gen, lm, ffn, params, chk,
                                "deepseek decode vs forward, bf16")
    log(f"  decode (MLA absorbed) vs forward, bf16, capacity_factor "
        f"{MLA_CHECK_CF}, batch {MLA_CHECK_BATCH}, {MLA_CHECK_POS} "
        f"positions: {text}")
    peak = check_peak(torch, dev, "deepseek-v2-lite-16b")
    log(f"  peak device memory {peak:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    f32 = dataclasses.replace(chk, dtype="float32")
    params = draw_model(torch, dev, lm, f32, seed,
                        "17 deepseek-v2-lite-16b, float32")
    rel, text = decode_vs_forward(torch, dev, gen, lm, ffn, params, f32,
                                  "deepseek decode vs forward, float32")
    log(f"  the same in float32: {text}")
    if rel > LM_REL_L2:
        raise AssertionError(f"deepseek decode vs forward, float32: rel L2 "
                             f"{rel:.3e} beyond {LM_REL_L2}")
    peak = check_peak(torch, dev, "deepseek-v2-lite-16b float32")
    log(f"  peak device memory {peak:.2f} GiB; phase 17 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    del params
    torch.cuda.empty_cache()


def kimi_phase(torch, dev, seed, runtime, gen) -> int:
    """Phase 18: kimi-k2-1t-a32b at full width cut to its dense layer and
    one MoE layer of 384 experts: prefill [1, 8192] with the kernel (2
    launches at head dim 112) against the plain path; ``LMDecoder``.
    Returns the prefill's flash_attention launches."""
    from repro_torch.configs import kimi_k2_1t_a32b
    from repro_torch.models.transformer import attention, ffn, lm
    from repro_torch.serve import LMDecoder
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(kimi_k2_1t_a32b.CONFIG, n_layers=KIMI_LAYERS)
    params = draw_model(torch, dev, lm, cfg, seed,
                        f"18 kimi-k2-1t-a32b, {KIMI_LAYERS}-layer cut")
    tokens = torch.randint(0, cfg.vocab, (1, LM_SEQ), generator=gen,
                           device=dev)
    torch.cuda.synchronize()
    runtime.reset_launches()
    with attention_calls(attention) as seen, \
            moe_assignments(torch, ffn) as moe:
        logits_k, _ = lm.forward(params, tokens, cfg, use_kernel=True)
        torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    log(f"  launches of one forward [1, {LM_SEQ}], use_kernel=True: "
        f"{launches}; head dims of the calls {[d for _, d in seen]}; "
        + dropped_text(moe))
    if launches["flash_attention"] != KIMI_LAYERS or \
            [d for _, d in seen] != [cfg.d_head] * KIMI_LAYERS:
        raise AssertionError(f"kimi prefill: {launches['flash_attention']} "
                             f"flash_attention launches, not {KIMI_LAYERS} "
                             f"at head dim {cfg.d_head}")
    t0 = time.perf_counter()
    logits_p, _ = lm.forward(params, tokens, cfg, use_kernel=False)
    torch.cuda.synchronize()
    log(f"  logits {tuple(logits_k.shape)} {logits_k.dtype}, kernel path vs "
        f"plain path ({time.perf_counter() - t0:.2f} s): "
        + lm_agreement(torch, "kimi-k2 prefill kernel vs plain", logits_k,
                       logits_p))
    del logits_k, logits_p
    text, times = timed_prefills(torch, lm, params, tokens, cfg)
    log(f"  prefill [1, {LM_SEQ}], use_kernel=True, 3 runs: {text}; "
        + router_share(torch, dev, ffn, cfg, times))
    serve_model(torch, dev, gen, LMDecoder, params, cfg, "kimi-k2")
    peak = check_peak(torch, dev, "kimi-k2-1t-a32b")
    log(f"  peak device memory {peak:.2f} GiB; phase 18 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    del params
    torch.cuda.empty_cache()
    return launches["flash_attention"]


def lm_family_phases(torch, dev, seed, runtime, records) -> None:
    """Phases 16-18, each model drawn from the seed in bf16 and freed
    before the next; fills the launches of phase 9's gemma3-27b and
    kimi-k2 records."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 16)
    by_name = {r["name"]: r for r in records}
    by_name["flash_attention (gemma3-27b prefill)"]["launches"] = \
        gemma_phase(torch, dev, seed, runtime, gen)
    deepseek_phase(torch, dev, seed, runtime, gen)
    by_name["flash_attention (kimi-k2 prefill)"]["launches"] = \
        kimi_phase(torch, dev, seed, runtime, gen)
    log(f"  LM phases 16-18 in {time.perf_counter() - t0:.1f} s")


def collection(torch, dev, args):
    """Phase 5's collection and its 4096 queries, drawn on the card from
    the seed (phase 15 and its ranks draw them again)."""
    from repro_torch.data import SyntheticSparseConfig, make_collection
    data_cfg = SyntheticSparseConfig(dim=DIM, n_docs=args.n_docs,
                                     n_queries=Q_BATCH, doc_nnz=DOC_NNZ,
                                     query_nnz=QUERY_NNZ, seed=args.seed)
    docs, queries, _ = make_collection(data_cfg, device=dev)
    torch.cuda.synchronize()
    return docs, queries


def retrieval_phases(torch, dev, args, runtime) -> tuple[list, dict]:
    """Phases 5-8 (the index, the flat and the hierarchical, refined
    paths, kernels a-f timed) -> (the six retrieval kernels' records,
    phase 7's index with its graph, the 256 queries and the offline
    recall@10 of phases 6 and 7, for phases 13 and 12)."""
    from repro_torch.core.build import build_index, live_blocks, \
        suggest_fanout
    from repro_torch.core.oracle import exact_topk, mean_recall_at_k
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
    docs, queries = collection(torch, dev, args)
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
    # phase 14's held-out sample: the next 256 rows of the 4096-query
    # batch, its exact top-10 against the float32 collection
    held = q4096[Q_ONLINE:2 * Q_ONLINE]
    _, held_exact = exact_topk(docs.coords, docs.vals, docs.dim,
                               held.coords, held.vals, 10)

    def seismic_row(res, ms):
        return (mean_recall_at_k(res[1], ex_i), float(res[2].float().mean()),
                sorted(ms)[1] / Q_ONLINE)
    return record, dict(
        index=index, queries=q256, recall_flat=recall_flat,
        recall_tuned=recalls[2][0], recall_route=recalls[0][0],
        exact=(ex_s, ex_i), held_out=held,
        held_exact=held_exact,
        table={"Seismic flat (phase 6)": seismic_row(
                   results[2, "server 256"], batch_ms[2, "server 256"]),
               "Seismic TUNED (phase 7)": seismic_row(
                   results_h[2, "server 256"],
                   batch_ms_h[2, "server 256"])})



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
    kept["rate"] = rate
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


def tuning_phase(torch, dev, args, runtime, smi, kept) -> dict:
    """Phase 14: the recall-target tuner on phase 7's index and graph.
    Returns the launches per kernel."""
    from repro_torch.core.oracle import mean_recall_at_k
    from repro_torch.retrieval import SearchParams, search_pipeline
    from repro_torch.serve import SeismicServer
    from repro_torch.tune import (default_grid, pareto_frontier, sweep,
                                  tune_and_attach, validate_tuned_index)

    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    index, held, exact = kept["index"], kept["held_out"], kept["held_exact"]

    def grid(fuse):
        return default_grid(index, k=10, cut=8, fuse_level=fuse) + [
            t.to_params(fuse_level=fuse) for t in CONFIG_TUNED.tuned]

    def measured(points):
        return [(knobs_from_params(pt.params), pt.recall, pt.docs_evaluated,
                 pt.router_cost) for pt in points]

    runtime.reset_launches()
    swept, secs = {}, {}
    for fuse in (1, 2):
        t0 = time.perf_counter()
        swept[fuse] = sweep(index, held, exact, grid=grid(fuse))
        secs[fuse] = time.perf_counter() - t0
    if measured(swept[1]) != measured(swept[2]):
        raise AssertionError("tuning: a measured point differs between fuse "
                             "levels 1 and 2")
    t0 = time.perf_counter()
    timed = sweep(index, held, exact, grid=grid(2), timings=True)
    secs["timings"] = time.perf_counter() - t0
    if measured(timed) != measured(swept[2]):
        raise AssertionError("tuning: the staged sweep's points differ from "
                             "the fused sweep's")
    log(f"[14 tuning] on {smi}: {len(swept[2])} points (default_grid, cut "
        f"8, plus CONFIG_TUNED's {len(CONFIG_TUNED.tuned)} modeled points) "
        f"over {held.n} held-out queries (rows {Q_ONLINE}-"
        f"{2 * Q_ONLINE - 1} of phase 5's batch); sweep seconds: fuse 1 "
        f"{secs[1]:.2f}, fuse 2 {secs[2]:.2f}, fuse 2 staged "
        f"{secs['timings']:.2f}; every point equal (recall, docs_evaluated, "
        "router_cost) at fuse 1, fuse 2 and staged")
    adv = {tuple(knobs_from_params(pt.params).items()): pt.advisory_seconds
           for pt in timed}

    def knob_text(p):
        k = knobs_from_params(p)
        route = (f"hier sb {k['superblock_budget']}"
                 if k["superblock_fanout"] else "flat")
        extra = {"adaptive": f" hf {k['heap_factor']}",
                 "global_threshold": f" tf {k['threshold_factor']}"}.get(
                     k["policy"], "")
        return (f"{k['policy']}{extra}, block_budget {k['block_budget']}, "
                f"{route}, "
                f"refine {k['graph_degree']}x{k['refine_rounds']}")
    for pt in pareto_frontier(swept[2]):
        a = adv[tuple(knobs_from_params(pt.params).items())]
        log(f"  frontier: {knob_text(pt.params)}: recall@10 "
            f"{pt.recall:.4f}, docs_evaluated {pt.docs_evaluated:.2f}, "
            f"router_cost {pt.router_cost}, staged {a * 1e3:.2f} ms")
    t0 = time.perf_counter()
    tuned_index = tune_and_attach(index, held, exact, targets=TUNE_TARGETS,
                                  grid=grid(2))
    validate_tuned_index(tuned_index)
    log(f"  tune_and_attach (targets {TUNE_TARGETS}) in "
        f"{time.perf_counter() - t0:.2f} s; the attached policies pass "
        "validate_tuned_index")
    for pol in tuned_index.tuned:
        log(f"  target {pol.target}: {knob_text(pol.to_params())}; held-out "
            f"recall@10 {pol.measured_recall:.4f}, docs_evaluated "
            f"{pol.measured_cost:.2f}, router_cost {pol.router_cost}, "
            f"fingerprint {pol.sample_fingerprint}")
    p95 = SearchParams.from_tuned(tuned_index, 0.95, fuse_level=2)
    res = SeismicServer(tuned_index, p95, max_batch=Q_ONLINE).search(
        kept["queries"])
    torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    rec = mean_recall_at_k(res.ids, kept["exact"][1])
    log(f"  from_tuned(0.95) at fuse 2 serves phase 7's {Q_ONLINE} queries: "
        f"recall@10 {rec:.4f}, mean docs_evaluated "
        f"{float(res.docs_evaluated.float().mean()):.1f} (TUNED, the modeled "
        f"point, in phase 7: {kept['recall_tuned']:.4f}); launches "
        f"{launches}")
    for name in ("summary_dot", "gather_dot_cand", "router_flat",
                 "router_hier", "refine_round"):
        if launches[name] <= 0:
            raise AssertionError(f"tuning: kernel {name} never launched")
    # the sweep's three runs all take the kernels: each attached point is
    # held to the plain path on the held-out queries
    for pol in tuned_index.tuned:
        label = f"tuning target {pol.target}"
        n_diff = check_against_plain(
            torch, label, search_pipeline(index, held, pol.to_params(
                fuse_level=2)),
            search_pipeline(index, held, pol.to_params(
                use_kernel=False, fuse_level=0)), 10)
        log(f"  {label} at fuse 2 vs the plain path on the {held.n} "
            f"held-out queries: scores within tolerance, {n_diff} rows "
            "with ids differing at non-isolated ties")
    log(f"  peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; phase 14 "
        f"in {time.perf_counter() - t_phase:.1f} s ({smi})")
    return {name: launches[name] for name in RETRIEVAL}


def shard_points():
    """Phase 15's two operating points, fuse 2: the flat SHAPES point and
    TUNED's route without refine (build_sharded_index builds no graph)."""
    from repro_torch.retrieval import SearchParams
    return {"flat": SearchParams(use_kernel=True, fuse_level=2, k=10,
                                 cut=CUT, block_budget=BLOCK_BUDGET),
            "TUNED route": SearchParams(use_kernel=True, fuse_level=2,
                                        **{**TUNED, "graph_degree": 0,
                                           "refine_rounds": 0})}


def shard_rank(args) -> int:
    """One rank of phase 15's ``make_distributed_search`` run (a process
    this script starts for itself): draw phase 5's collection, build this
    rank's shard (ranks build one after another, so one build's scratch
    is on the card at a time), search phase 7's 256 queries at both
    points, and write the answers (rank 0), the launches, the times and
    the peak memory under ``--out``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.build import build_index
    from repro_torch.core.distributed import (make_distributed_search,
                                              shard_collection)
    from repro_torch.kernels import runtime
    from repro_torch.sparse.ops import PaddedSparse

    rank, out = args.shard_rank, Path(args.out)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{args.port}", world_size=N_SHARDS, rank=rank)
    mesh = init_device_mesh("cpu", (1, N_SHARDS),
                            mesh_dim_names=("data", "model"))
    shard = mesh.get_local_rank("model")
    docs, queries = collection(torch, dev, args)
    q256 = queries[:Q_ONLINE]
    n_docs = docs.n
    sharded = shard_collection(docs, N_SHARDS)
    mine = PaddedSparse(sharded.coords[shard].clone(),
                        sharded.vals[shard].clone(), DIM)
    del docs, queries, sharded
    torch.cuda.empty_cache()
    draw_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    icfg = dataclasses.replace(ICFG, seed=args.seed)
    t_build = 0.0
    for turn in range(N_SHARDS):
        if turn == rank:
            t0 = time.perf_counter()
            local = build_index(mine, icfg, list_chunk=SHARD_LIST_CHUNK)
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
            del mine
            torch.cuda.empty_cache()
        dist.barrier()
    answers, ms = {}, {}
    runtime.reset_launches()
    for name, p in shard_points().items():
        search = make_distributed_search(mesh, p, doc_axes=("model",),
                                         data_axis="data", n_docs=n_docs)
        times = []
        for _ in range(4):
            dist.barrier()
            t0 = time.perf_counter()
            s, ids = search(local, q256.coords, q256.vals)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        answers[name] = (s.cpu(), ids.cpu())
        ms[name] = times
    if rank == 0:
        torch.save(answers, out / "answers.pt")
    (out / f"rank{rank}.json").write_text(json.dumps(dict(
        rank=rank, shard=shard, build_s=t_build, ms=ms,
        launches=dict(runtime.LAUNCHES), draw_gib=draw_gib,
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
        reserved_gib=torch.cuda.max_memory_reserved(dev) / 2**30,
        resident_gib=torch.cuda.memory_allocated(dev) / 2**30)))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def run_ranks(args, out: Path) -> list[dict]:
    """Start the N_SHARDS ranks of :func:`shard_rank` on a free local port
    and wait for all; every rank is ended before this returns. The ranks'
    allocators map memory in expandable segments, so a rank's build
    scratch leaves no cached blocks it cannot give back."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out.mkdir(parents=True, exist_ok=True)
    for f in out.iterdir():
        f.unlink()
    env = dict(os.environ,
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--n-docs",
         str(args.n_docs), "--seed", str(args.seed), "--shard-rank",
         str(r), "--port", str(port), "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
        for r in range(N_SHARDS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError("a make_distributed_search rank failed:\n"
                             + "\n".join(f"--- rank {r} (rc {p.returncode})"
                                         f"\n{o[-4000:]}" for r, (p, o)
                                         in enumerate(zip(procs, logs))))
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(N_SHARDS)]


class CardPeak:
    """The card's used memory (every process on it with its CUDA context,
    ``mem_get_info``), sampled every 0.2 s on a thread while the ``with``
    block runs; ``peak`` keeps the largest sample of each stage named by
    ``stage``."""

    def __init__(self, torch, dev):
        self.info = lambda: torch.cuda.mem_get_info(dev)
        self.current, self.peak = "", {}
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def stage(self, name: str) -> None:
        self.sample()
        self.current = name
        self.sample()

    def sample(self) -> None:
        if not self.current:
            return
        free, total = self.info()
        used = (total - free) / 2**30
        self.peak[self.current] = max(self.peak.get(self.current, 0.0), used)

    def _run(self) -> None:
        while not self._done.wait(0.2):
            self.sample()

    def __enter__(self) -> "CardPeak":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._done.set()
        self._thread.join()
        self.sample()


def exact_scores(torch, docs, q, ids, dtype=None):
    """float64 <q, doc> for ids [Q, k] (-1 -> nan), the docs' values first
    rounded to ``dtype`` (the forward plane's) when given."""
    from repro_torch.sparse.ops import densify
    qd = densify(q, dtype=torch.float64)
    safe = ids.long().clamp(min=0)
    c = docs.coords[safe].long()                             # [Q, k, nnz]
    vals = docs.vals[safe]
    if dtype is not None:
        vals = vals.to(dtype)
    ip = (qd.gather(1, c.reshape(q.n, -1)).reshape(c.shape)
          * vals.double()).sum(-1)
    return torch.where(ids >= 0, ip, torch.nan)


def sharded_phase(torch, dev, args, runtime, smi, kept) -> dict:
    """Phase 15: doc-sharded search three ways and the paper's baselines
    on phase 5's collection, the card's used memory held to
    ``CARD_LIMIT_GIB`` at every stage. Returns the launches per kernel."""
    with CardPeak(torch, dev) as card:
        launches = sharded_stages(torch, dev, args, runtime, smi, kept, card)
    log(f"  the card's used memory (every process with its CUDA context, "
        f"sampled every 0.2 s) at its peak in each stage of phase 15: "
        + ", ".join(f"{k} {v:.2f} GiB" for k, v in card.peak.items())
        + f" (budget {CARD_LIMIT_GIB:g} GiB; {smi})")
    over = {k: v for k, v in card.peak.items() if v >= CARD_LIMIT_GIB}
    if over:
        raise AssertionError(f"sharded: the card's used memory reached "
                             f"{over} GiB, budget {CARD_LIMIT_GIB:g}")
    return launches


def sharded_stages(torch, dev, args, runtime, smi, kept, card) -> dict:
    """The stages of :func:`sharded_phase`, each named to ``card``."""
    import numpy as np

    from repro_torch.core.baselines import (build_ivf, exact_search,
                                            impact_search, ivf_search)
    from repro_torch.core.build import build_index
    from repro_torch.core.distributed import (build_sharded_index,
                                              search_shards)
    from repro_torch.core.oracle import mean_recall_at_k
    from repro_torch.retrieval import search_pipeline
    from repro_torch.serve import ReplicaSeismicServer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    card.stage("build_sharded_index")
    docs, queries = collection(torch, dev, args)
    q256 = queries[:Q_ONLINE]
    del queries
    if not (torch.equal(q256.coords, kept["queries"].coords)
            and torch.equal(q256.vals, kept["queries"].vals)):
        raise AssertionError("sharded: the collection drawn again differs "
                             "from phase 5's")
    ex_s, ex_i = kept["exact"]
    icfg = dataclasses.replace(ICFG, seed=args.seed)
    t0 = time.perf_counter()
    sharded = build_sharded_index(docs, icfg, N_SHARDS,
                                  list_chunk=SHARD_LIST_CHUNK)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()    # the builds' scratch
    log(f"[15 sharded + baselines] on {smi}: build_sharded_index "
        f"{N_SHARDS} x {sharded.per_shard} docs in "
        f"{time.perf_counter() - t0:.1f} s, {sharded.nbytes()} bytes; peak "
        f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
        "GiB")
    points = shard_points()
    single = {"flat": kept["recall_flat"],
              "TUNED route": kept["recall_route"]}
    launches = {name: 0 for name in RETRIEVAL}

    def add_launches(counts):
        for name in RETRIEVAL:
            launches[name] += counts[name]

    def route_of(counts):
        return {k for k, n in counts.items() if n}

    # (i) in process: each shard's pipeline, masked, merged
    card.stage("(i) and (ii)")
    refs, routes = {}, {}
    for name, p in points.items():
        runtime.reset_launches()
        out = search_shards(sharded, q256, p)
        torch.cuda.synchronize()
        counts = dict(runtime.LAUNCHES)
        add_launches(counts)
        routes[name] = route_of(counts)
        want = "router_flat" if name == "flat" else "router_hier"
        if want not in routes[name] or "gather_dot_cand" not in routes[name]:
            raise AssertionError(f"sharded {name}: route {routes[name]}")
        # every shard's kernel path held to its plain path (PLAIN_ROWS
        # queries a call; rows are answered independently): (ii) and
        # (iii) are held to (i) bitwise below, and all three take the
        # kernels
        plain = dataclasses.replace(p, use_kernel=False, fuse_level=0)
        ev, n_diff = 0, 0
        for s, local in enumerate(sharded.shards):
            got = search_pipeline(local, q256, p)
            ref = [search_pipeline(local, q256[a:a + PLAIN_ROWS], plain)
                   for a in range(0, q256.n, PLAIN_ROWS)]
            n_diff += check_against_plain(
                torch, f"sharded {name} shard {s}", got,
                tuple(torch.cat(parts) for parts in zip(*ref)), 10)
            ev = ev + got[2]
        del local, got, ref     # the last shard goes with ``sharded``
        if not torch.equal(ev, out[2]):
            raise AssertionError(f"sharded {name}: docs_evaluated is not the "
                                 "per-shard sum")
        ids = out[1]
        if bool(((ids < -1) | (ids >= args.n_docs)).any()):
            raise AssertionError(f"sharded {name}: an id out of range")
        # over the forward plane's values (bf16 at the MS MARCO widths)
        ip = exact_scores(torch, docs, q256, ids,
                          sharded.shard(0).fwd.vals.dtype)
        live = ids >= 0
        err = (out[0].double() - ip).abs()[live]
        bound = SCORE_TOL * ip.abs().clamp(min=1.0)[live]
        if bool((err > bound).any()):
            raise AssertionError(f"sharded {name}: a score is not the exact "
                                 "inner product")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            search_shards(sharded, q256, p)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        refs[name] = out
        rec = mean_recall_at_k(ids, ex_i)
        log(f"  (i) in process, {name}: recall@10 {rec:.4f}"
            + f" (single index, phases 6-7: {single[name]:.4f})"
            + f", mean docs_evaluated {float(out[2].float().mean()):.1f} "
            f"(the shards' sum), ms per batch of {Q_ONLINE} "
            f"{['%.2f' % t for t in times]}; scores exact (max abs "
            f"{float(err.max()):.2e}); every shard's kernel path vs its "
            f"plain path: scores within tolerance, {n_diff} shard rows with "
            f"ids differing at non-isolated ties; launches {counts}")
    refs_np = {name: tuple(t.cpu().numpy() for t in r)
               for name, r in refs.items()}

    # (ii) shard-mode replicas: phase 13's traffic, a swap mid-traffic
    c = q256.coords.cpu().numpy()
    v = q256.vals.cpu().numpy()
    srv = ReplicaSeismicServer(
        sharded, points["flat"], mode="shard", max_batch=SERVE_MAX_BATCH,
        query_nnz=QUERY_NNZ, deadline_s=SERVE_DEADLINE,
        queue_bound=SERVE_QUEUE, cache_size=SERVE_CACHE, coalesce=True)

    # the swap lands inside the first part's traffic (at 60 % of its
    # expected span), without warmup, so jobs are dispatched and in flight
    # on both sides of it; the second part starts after it
    units = serving_traffic(args.seed)
    swap = threading.Timer(0.6 * len(units) / kept["rate"], lambda: (
        srv.swap_index(sharded, points["TUNED route"], warmup=False)))
    try:
        srv.start()
        runtime.reset_launches()
        swap.start()
        subs, secs, sent = drive_clients(srv, units, c, v, kept["rate"],
                                         args.seed, halves=2,
                                         between=swap.join)
    finally:
        swap.cancel()
        srv.stop()
    counts = dict(runtime.LAUNCHES)
    add_launches(counts)
    n_ans = check_answers("shard mode", subs,
                          {0: refs_np["flat"], 1: refs_np["TUNED route"]},
                          accept=refs_np["TUNED route"])
    missing = (routes["flat"] | routes["TUNED route"]) - route_of(counts)
    if missing:
        raise AssertionError(f"shard mode: {missing} never launched")
    log(f"  (ii) ReplicaSeismicServer(mode='shard', {N_SHARDS} replicas), "
        "flat then a swap_index to the TUNED route: "
        + latency_line(subs, secs, sent)
        + f"; every answer bitwise (i)'s ({n_ans['cached']} cached, "
        f"{n_ans['coalesced']} coalesced, {n_ans['after swap']} after the "
        f"swap); {srv.telemetry_export()['counters']['batches']} merged "
        f"launches; launches {counts}")
    # the ranks draw the collection themselves: it is drawn again after
    del srv, sharded, docs
    torch.cuda.empty_cache()
    log(f"  the shards and the collection freed: "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated")

    # (iii) make_distributed_search on N_SHARDS ranks over gloo
    card.stage("(iii)")
    t0 = time.perf_counter()
    ranks = run_ranks(args, ROOT / "build" / "phase15")
    card.stage("baselines")
    resident = sum(r["resident_gib"] for r in ranks)
    together = max(resident - r["resident_gib"] + r["peak_gib"]
                   for r in ranks)
    answers = torch.load(ROOT / "build" / "phase15" / "answers.pt")
    for name, (s, ids) in answers.items():
        want_s, want_i = refs[name][0].cpu(), refs[name][1].cpu()
        if not (torch.equal(ids, want_i) and torch.equal(
                s.view(torch.int32), want_s.view(torch.int32))):
            raise AssertionError(f"make_distributed_search {name}: answers "
                                 "differ from the in-process route's")
    for r in ranks:
        add_launches(r["launches"])
        missing = (routes["flat"] | routes["TUNED route"]) \
            - route_of(r["launches"])
        if missing:
            raise AssertionError(f"rank {r['rank']}: {missing} never "
                                 "launched")
    log(f"  (iii) make_distributed_search on {N_SHARDS} gloo ranks sharing "
        f"the card, a (1, {N_SHARDS}) mesh: {time.perf_counter() - t0:.1f} s "
        "with the ranks' start, draws and builds; answers bitwise (i)'s at "
        "both points; ms per batch (rank 0, after one warm run) "
        + "; ".join(f"{n} {['%.2f' % t for t in ts[1:]]}"
                    for n, ts in ranks[0]["ms"].items())
        + "; shard builds s " + str([round(r["build_s"], 1) for r in ranks])
        + "; GiB per rank (draw peak, peak, reserved peak, resident) " + str(
            [tuple(round(r[k], 2) for k in ("draw_gib", "peak_gib",
                                            "reserved_gib", "resident_gib"))
             for r in ranks])
        + f"; the ranks' allocations together at most {together:.2f} GiB "
        "(one rank's build peak beside the others' built shards)")

    # baselines, on the same collection and queries
    docs, _ = collection(torch, dev, args)
    table = dict(kept["table"])
    for name in points:
        table[f"Seismic {name}, {N_SHARDS} shards"] = None

    def timed(fn, runs=2):
        out, best = None, float("inf")
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return out, best * 1e3 / Q_ONLINE
    (es, ei), ms = timed(lambda: exact_search(docs, q256, 10))
    diff = ei.long() != ex_i
    if bool(diff.any()):
        a = exact_scores(torch, docs, q256, ei)[diff]
        b = ex_s[diff]
        if bool(((a - b).abs() > RTOL * b.abs()).any()):
            raise AssertionError("exact_search: ids differ from exact_topk's "
                                 "away from a tie")
    table["exact_search"] = (mean_recall_at_k(ei, ex_i), float(docs.n), ms)
    log(f"  exact_search (float32): ids equal exact_topk's (float64) except "
        f"{int(diff.sum())} at ties; {ms:.4f} ms a query")
    n_clusters = int(4 * args.n_docs ** 0.5)
    builds = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        builds.append(build_ivf(docs, n_clusters, IVF_CAP, IVF_ITERS,
                                seed=0))
        torch.cuda.synchronize()
        builds[-1] = (builds[-1], time.perf_counter() - t0)
    (ivf, t1), (ivf2, t2) = builds
    for f in ("centroids", "member_docs", "member_len"):
        if not torch.equal(getattr(ivf, f), getattr(ivf2, f)):
            raise AssertionError(f"build_ivf: two builds differ in {f}")
    del ivf2, builds
    log(f"  build_ivf ({n_clusters} clusters, cap {IVF_CAP}, {IVF_ITERS} "
        f"iterations, seed 0): {t1:.1f} / {t2:.1f} s, two builds bitwise "
        f"equal; {ivf.nbytes()} bytes; members kept "
        f"{int(ivf.member_len.clamp(max=IVF_CAP).sum())} of {docs.n}; peak "
        f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
        "GiB")
    for nprobe in IVF_NPROBE:
        (s, ids, ev), ms = timed(lambda: ivf_search(ivf, q256, 10, nprobe))
        table[f"IVF nprobe {nprobe}"] = (mean_recall_at_k(ids, ex_i),
                                         float(ev.float().mean()), ms)
    del ivf
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lists = build_index(docs, dataclasses.replace(icfg, superblock_fanout=0))
    torch.cuda.synchronize()
    log(f"  the unsharded index's lists for impact_search (a build without "
        f"the superblock tier, which the lists do not depend on): "
        f"{time.perf_counter() - t0:.1f} s")
    qc = q256.coords.long()
    for b in IMPACT_POSTINGS:
        (s, ids), ms = timed(lambda: impact_search(
            lists.list_docs, lists.list_vals, lists.list_len, lists.n_docs,
            q256, 10, b))
        touched = torch.where(q256.vals > 0,
                              lists.list_len[qc].clamp(max=b), 0).sum(1)
        table[f"impact {b} postings a list"] = (
            mean_recall_at_k(ids, ex_i), float(touched.float().mean()), ms)
    del lists
    torch.cuda.empty_cache()
    for name in points:
        r = refs[name]
        table[f"Seismic {name}, {N_SHARDS} shards"] = (
            mean_recall_at_k(r[1], ex_i), float(r[2].float().mean()),
            float(np.median(ranks[0]["ms"][name][1:])) / Q_ONLINE)
    log(f"  Table 1 on {args.n_docs} docs, {Q_ONLINE} queries, k 10 ({smi}); "
        "docs a query: exactly scored (impact: postings accumulated); ms a "
        "query: a batch's ms over its queries (Seismic rows: the 256-query "
        "server at fuse 2, phases 6-7; sharded rows: rank 0 of (iii))")
    for name, (rec, d, ms) in table.items():
        log(f"    {name:<34} recall@10 {rec:.4f}  docs {d:>12.1f}  "
            f"ms {ms:.4f}")
    log(f"  launches in phase 15 ((i), (ii) and the ranks of (iii)): "
        f"{launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB (this "
        f"process); phase 15 in {time.perf_counter() - t_phase:.1f} s "
        f"({smi})")
    return launches


# ---------------------------------------------------------------------------
# phases 19-21: Seismic's serving CLI, LM training on one card
# ---------------------------------------------------------------------------

def cli_phase(torch, dev, runtime) -> dict:
    """Phase 19: ``repro_torch.launch.serve.main`` at its defaults, at
    CLI_WIDE and at CLI_WIDE with 4 doc shards. Each run's launches
    counted (summary_dot and gather_dot_cand asserted), every id valid,
    its answer held to the plain path (use_kernel=False, fuse 0) on the
    same index and queries, both recalls printed. Returns the launches
    by kernel name."""
    from repro_torch.core.distributed import search_shards
    from repro_torch.core.oracle import mean_recall_at_k
    from repro_torch.launch import serve
    from repro_torch.serve.engine import SeismicServer
    t_phase = time.perf_counter()
    total = {name: 0 for name in runtime.LAUNCHES}
    for label, argv in (("defaults", []), ("wide", CLI_WIDE),
                        (f"wide, {N_SHARDS} doc shards",
                         CLI_WIDE + ["--doc-shards", str(N_SHARDS)])):
        args = serve.parse_args(argv)
        torch.cuda.synchronize()
        runtime.reset_launches()
        t0 = time.perf_counter()
        out = serve.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(runtime.LAUNCHES)
        for name, n in launches.items():
            total[name] += n
        if not (launches["summary_dot"] and launches["gather_dot_cand"]):
            raise AssertionError(f"serve CLI ({label}) launched {launches}: "
                                 "summary_dot and gather_dot_cand expected")
        ids, q = out["ids"], out["queries"]
        n_docs = args.n_docs
        if ids.shape != (args.queries, args.k) or bool(
                ((ids < 0) | (ids >= n_docs)).any()):
            raise AssertionError(f"serve CLI ({label}): ids of shape "
                                 f"{tuple(ids.shape)} or outside "
                                 f"[0, {n_docs})")
        plain_p = serve.search_params(args, use_kernel=False, fuse_level=0)
        if args.doc_shards > 1:
            ref = search_shards(out["index"], q, plain_p)
        else:
            ref = as_triple(SeismicServer(out["index"], plain_p,
                                          max_batch=min(args.queries, 256))
                            .search(q))
        if not torch.equal(ref[2].to(torch.int32), out["docs_evaluated"]):
            raise AssertionError(f"serve CLI ({label}): docs_evaluated "
                                 "differs from the plain path's")
        rows = check_against_plain(torch, f"serve CLI ({label})",
                                   (out["scores"], ids), ref, args.k)
        plain_recall = mean_recall_at_k(ref[1], out["exact_ids"])
        log(f"[19 serve CLI, {label}] argv {argv or '(defaults)'}: "
            f"{args.n_docs} docs, d {args.dim}, {args.queries} queries, "
            f"k {args.k}, budget {args.budget}, cut {args.cut}: "
            f"{out['seconds'] * 1e3:.1f} ms to answer "
            f"({out['seconds'] / args.queries * 1e6:.0f} us a query), "
            f"{wall:.1f} s in all; recall@{args.k} {out['recall']:.4f} "
            f"(plain path {plain_recall:.4f}); docs evaluated (mean) "
            f"{float(out['docs_evaluated'].float().mean()):.1f}; launches "
            f"{ {k: v for k, v in launches.items() if v} }; rows whose ids "
            f"differ from the plain path (at ties) {rows}")
        del out, ref, q
        torch.cuda.empty_cache()
    log(f"  phase 19 in {time.perf_counter() - t_phase:.1f} s")
    return total


def state_fingerprint(torch, opt) -> list[int]:
    """A bitwise fingerprint of AdamW's moments: per tensor, the sum of
    its float32 bit patterns weighted by position (mod 65521)."""
    out = []
    for k in ("m", "v"):
        for t in opt[k].values():
            bits = t.view(torch.int32).reshape(-1).long()
            w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
            out.append(int((bits * w).sum()))
            del bits, w
    return out


def train_phase(torch, dev, seed, smi) -> None:
    """Phase 20: llama3-8b at full width cut to TRAIN_LAYERS layers (bf16,
    remat as configured) trains on [TRAIN_BATCH, TRAIN_SEQ] batches from
    ``lm_token_stream`` through ``PrefetchLoader`` in TRAIN_MICRO
    microbatches. Asserted: ``loss_fn(use_kernel=True)`` raises under
    autograd; every loss finite; on one repeated batch the loss after 5
    steps below step 0's; 2 steps, ``save_async``, a restore into freshly
    drawn parameters and 2 more steps bitwise equal to 4 uninterrupted
    steps; the allocator's peak under MODEL_PEAK_GIB. Printed: ms a step,
    tokens/s and model FLOP/s as a share of the bf16 dense peak."""
    import shutil

    import numpy as np
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import llama3_8b
    from repro_torch.data.pipeline import PrefetchLoader, lm_token_stream
    from repro_torch.launch.train import load_state, state_tree
    from repro_torch.models.transformer import lm
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(llama3_8b.CONFIG, n_layers=TRAIN_LAYERS)
    params = draw_model(torch, dev, lm, cfg, seed,
                        f"20 llama3-8b training, {TRAIN_LAYERS}-layer cut")
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=100)
    step_fn = make_train_step(lambda p, b: lm.loss_fn(p, b, cfg), opt_cfg,
                              microbatches=TRAIN_MICRO)
    loader = PrefetchLoader(lm_token_stream(cfg.vocab, TRAIN_BATCH,
                                            TRAIN_SEQ, seed=seed),
                            prefetch=2)
    stream = iter(loader)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                next(stream).items()} for _ in range(5)]
    loader.close()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    try:
        lm.loss_fn(params, {k: v[:1] for k, v in batches[0].items()}, cfg,
                   use_kernel=True)
    except RuntimeError as exc:
        if "no backward" not in str(exc):
            raise
        log(f"  loss_fn(use_kernel=True) under autograd raises: {exc}")
    else:
        raise AssertionError("loss_fn(use_kernel=True) ran under autograd")

    def run(p, o, bs, timed=False):
        losses, times = [], []
        for b in bs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, m = step_fn(p, o, b)
            loss = float(m["loss"])          # a host read: the step's end
            times.append((time.perf_counter() - t0) * 1e3)
            if not np.isfinite(loss):
                raise AssertionError(f"llama3-8b training: loss {loss}")
            losses.append(loss)
        return p, o, losses, times

    # one repeated batch: the loss must fall; steps 1-3 timed
    opt = init_opt_state(params)
    params, opt, losses, times = run(params, opt, [batches[0]] * 6)
    log(f"  6 steps on one repeated batch [{TRAIN_BATCH}, {TRAIN_SEQ}] in "
        f"{TRAIN_MICRO} microbatches (AdamW lr {TRAIN_LR}, warmup 2): "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}; ms a step "
        + ", ".join(f"{t:.1f}" for t in times))
    if not losses[5] < losses[0]:
        raise AssertionError(f"llama3-8b training: loss after 5 steps "
                             f"{losses[5]:.4f} not below step 0's "
                             f"{losses[0]:.4f}")
    ms = float(np.mean(times[1:4]))
    n = cfg.param_count()
    flops = 6 * n * tokens / (ms / 1e3)
    log(f"  [train] ms a step (steps 1-3 after a warm step 0): {ms:.1f} "
        f"({', '.join(f'{t:.1f}' for t in times[1:4])}); tokens/s "
        f"{tokens / ms * 1e3:.0f}; model FLOP/s (6 x {n} parameters x "
        f"{tokens} tokens / step time) {flops / 1e12:.1f} T, "
        f"{flops / BF16_OPS_PER_S:.4f} of the bf16 dense peak "
        f"{BF16_OPS_PER_S / 1e12:.0f} T; card {smi}")
    peak = check_peak(torch, dev, "llama3-8b training")
    log(f"  peak device memory {peak:.2f} GiB")

    # resume: 4 uninterrupted steps against 2 + save + restore + 2
    ckpt_dir = ROOT / "build" / "smoke_train_ckpt"   # the smoke's own
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del params, opt
    torch.cuda.empty_cache()
    params = lm.init_params(cfg, seed=seed, device=dev)
    opt = init_opt_state(params)
    params, opt, l4, _ = run(params, opt, batches[1:5])
    want = [p.detach().clone() for p in params.parameters()]
    want_fp, want_step = state_fingerprint(torch, opt), int(opt["step"])
    del params, opt
    torch.cuda.empty_cache()
    params = lm.init_params(cfg, seed=seed, device=dev)
    opt = init_opt_state(params)
    params, opt, l2, _ = run(params, opt, batches[1:3])
    mgr = CheckpointManager(str(ckpt_dir), keep=1)
    t0 = time.perf_counter()
    mgr.save_async(2, state_tree(params, opt))
    t_snap = time.perf_counter() - t0
    del params, opt
    torch.cuda.empty_cache()
    params = lm.init_params(cfg, seed=seed + 1, device=dev)   # fresh draws
    opt = init_opt_state(params)
    mgr.wait()
    t_save = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in ckpt_dir.rglob("*") if f.is_file())
    t0 = time.perf_counter()
    restored, step = mgr.restore_latest(
        state_tree(params, opt, device="meta"), device="cpu")
    load_state(restored, params, opt)
    del restored
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    params, opt, l2b, _ = run(params, opt, batches[3:5])
    same = all(torch.equal(a, b) for a, b in zip(params.parameters(), want))
    same_opt = state_fingerprint(torch, opt) == want_fp \
        and int(opt["step"]) == want_step
    log(f"  resume: 4 steps, losses {', '.join(f'{x:.4f}' for x in l4)}; "
        f"2 steps ({', '.join(f'{x:.4f}' for x in l2)}), save_async "
        f"(host snapshot {t_snap:.1f} s, written {t_save:.1f} s, "
        f"{size / 2**30:.2f} GiB), restored step {step} into fresh draws "
        f"({t_load:.1f} s), 2 steps ({', '.join(f'{x:.4f}' for x in l2b)}):"
        f" parameters bitwise equal {same}, moments and step equal "
        f"{same_opt}")
    if not (same and same_opt and l2 + l2b == l4):
        raise AssertionError("llama3-8b training: the resumed run is not "
                             "bitwise the uninterrupted one")
    peak = check_peak(torch, dev, "llama3-8b training")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del params, opt, want, batches
    torch.cuda.empty_cache()
    log(f"  peak device memory {peak:.2f} GiB; phase 20 in "
        f"{time.perf_counter() - t_phase:.1f} s")


def deepseek_train_phase(torch, dev, seed, gen) -> None:
    """Phase 21: deepseek-v2-lite-16b at full width cut to its dense
    layer and one MoE layer (64 experts, top 6, 2 shared, MLA), bf16:
    one warm and one timed microbatched step on [2, TRAIN_SEQ] (2
    microbatches). Asserted: finite loss and aux, the aux loss's gradient
    reaches the router (and the step's first moment of the router is
    non-zero), the allocator's peak under MODEL_PEAK_GIB."""
    import numpy as np
    from repro_torch.configs import deepseek_v2_lite_16b
    from repro_torch.models.transformer import lm
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(deepseek_v2_lite_16b.CONFIG, n_layers=2)
    params = draw_model(torch, dev, lm, cfg, seed,
                        "21 deepseek-v2-lite-16b training, 2-layer cut")
    toks = torch.randint(0, cfg.vocab, (2, TRAIN_SEQ + 1), generator=gen,
                         device=dev)
    batch = dict(tokens=toks[:, :-1].to(torch.int32).contiguous(),
                 labels=toks[:, 1:].to(torch.int32).contiguous())
    router = params.layers[0].ffn.router
    _, aux = lm.forward_train(params, batch["tokens"][:1], cfg)
    (g,) = torch.autograd.grad(aux, [router])
    if not (bool(torch.isfinite(aux)) and bool(g.abs().sum() > 0)):
        raise AssertionError(f"deepseek training: aux {float(aux)}, its "
                             "gradient does not reach the router")
    log(f"  aux of one [1, {TRAIN_SEQ}] forward {float(aux.detach()):.4f}; "
        f"|d aux / d router| sum {float(g.abs().sum()):.4e}")
    del aux, g
    opt = init_opt_state(params)
    step_fn = make_train_step(lambda p, b: lm.loss_fn(p, b, cfg),
                              AdamWConfig(lr=TRAIN_LR, warmup_steps=2),
                              microbatches=2)
    times, losses = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    m_router = opt["m"]["layers.0.ffn.router"]
    if not (np.isfinite(losses).all() and bool(m_router.abs().sum() > 0)):
        raise AssertionError(f"deepseek training: losses {losses}, router "
                             "moment zero")
    peak = check_peak(torch, dev, "deepseek-v2-lite-16b training")
    log(f"  [train] 2 steps on [2, {TRAIN_SEQ}] in 2 microbatches: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; ms a step "
        f"{times[0]:.1f} (warm), {times[1]:.1f}; tokens/s "
        f"{2 * TRAIN_SEQ / times[1] * 1e3:.0f}; router's first moment "
        f"non-zero; peak device memory {peak:.2f} GiB; phase 21 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    del params, opt, m
    torch.cuda.empty_cache()


def card_vs_cpu_phase(torch, dev, seed) -> None:
    """llama3-8b and deepseek-v2-lite-16b REDUCED in float32: 3 train
    steps on the card and on the CPU from the same parameters and
    batches. Losses within ``rtol`` 1e-4; parameters after 3 steps 99.9 %
    within 5e-3 lr a step and all within lr / 4 a step, the bounds the
    CPU tests hold the port to JAX with (tests/test_torch_train.py): the
    same float32 sums in another order (TF32 is off), which AdamW's
    normalised step can turn into a flipped step of about lr on an
    element whose gradient is near zero."""
    from repro_torch.configs import deepseek_v2_lite_16b, llama3_8b
    from repro_torch.data.pipeline import lm_token_stream
    from repro_torch.models.transformer import lm
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
    for mod in (llama3_8b, deepseek_v2_lite_16b):
        cfg = mod.REDUCED
        ocfg = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=20)
        step_fn = make_train_step(lambda p, b: lm.loss_fn(p, b, cfg), ocfg,
                                  microbatches=2)
        gen = lm_token_stream(cfg.vocab, 4, 32, seed=seed)()
        batches = [next(gen) for _ in range(3)]
        out = {}
        for where in ("cpu", dev):
            params = lm.init_params(cfg, seed=seed, device="cpu").to(where)
            opt = init_opt_state(params)
            losses = []
            for b in batches:
                params, opt, m = step_fn(params, opt, {
                    k: torch.from_numpy(v).to(where) for k, v in b.items()})
                losses.append(float(m["loss"]))
            out[str(where)] = (losses, [p.detach().cpu() for p in
                                        params.parameters()])
        (lc, pc), (lg, pg) = out["cpu"], out[str(dev)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
        worst, share = 0.0, 0.0
        for a, b in zip(pg, pc):
            d = (a - b).abs()
            worst = max(worst, float(d.max()))
            share = max(share, float((d > 5e-3 * ocfg.lr * 3).float().mean()))
        log(f"  card vs CPU, {cfg.name}, float32, 3 steps: losses card "
            f"{', '.join(f'{x:.6f}' for x in lg)}, CPU "
            f"{', '.join(f'{x:.6f}' for x in lc)} (max rel {rel:.2e}); "
            f"parameters max |diff| {worst:.3e} = {worst / ocfg.lr:.4f} lr, "
            f"share beyond 5e-3 lr a step {share:.2e}")
        if rel > 1e-4 or worst > 0.25 * ocfg.lr * 3 or share > 1e-3:
            raise AssertionError(f"{cfg.name}: card and CPU training differ "
                                 "beyond the bound")


def train_phases(torch, dev, seed, smi) -> None:
    """Phases 20 and 21, then the card against the CPU."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    train_phase(torch, dev, seed, smi)
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    deepseek_train_phase(torch, dev, seed, gen)
    card_vs_cpu_phase(torch, dev, seed)
    log(f"  training phases 20-21 in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phases 22-23: the recsys and GNN families at their configs' full widths


def family_module(cfg):
    """The port's model module of a recsys or GNN config."""
    from repro_torch.models.gnn import gin
    from repro_torch.models.recsys import bst, fm, sasrec, wide_deep
    if cfg.family == "gnn":
        return gin
    return {"fm-2way": fm, "concat": wide_deep, "self-attn-seq": sasrec,
            "transformer-seq": bst}[cfg.interaction]


def to_cpu(cfg, params):
    """A copy of a family's parameters on the CPU, through the JAX layout
    (``params_to_jax`` then ``params_from_jax``)."""
    mod = family_module(cfg)
    return mod.params_from_jax(mod.params_to_jax(params, cfg), cfg,
                               device="cpu")


def family_train(torch, dev, bundle, cfg, dims, batch, seed, label, lr):
    """FAMILY_STEPS AdamW steps at ``lr`` on one repeated batch from the
    seed's draws, twice. Asserted: every loss finite, the loss after the steps
    below step 0's, the two runs' parameters bitwise equal. Returns
    (the second run's parameters, its losses, the loss after, ms of each
    step)."""
    import numpy as np
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
    loss_fn = bundle.step(cfg, dims, "train")
    step_fn = make_train_step(loss_fn, AdamWConfig(
        lr=lr, warmup_steps=1, total_steps=100))
    runs = []
    for _ in range(2):
        params = bundle.init(seed, cfg, dims, device=dev)
        opt = init_opt_state(params)
        losses, times = [], []
        for _ in range(FAMILY_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            losses.append(float(m["loss"]))      # a host read: the step's end
            times.append((time.perf_counter() - t0) * 1e3)
        del opt, m
        with torch.no_grad():
            after = float(loss_fn(params, batch))
        if not (np.isfinite(losses + [after]).all() and after < losses[0]):
            raise AssertionError(f"{label}: losses {losses}, then {after}: "
                                 "not finite or not falling")
        if runs:
            same = all(torch.equal(a, b) for a, b in
                       zip(runs[0], params.parameters()))
            if not (same and losses == runs[1]):
                raise AssertionError(f"{label}: two runs of {FAMILY_STEPS} "
                                     "steps from one seed differ")
            return params, losses, after, times
        runs = [[p.detach().clone() for p in params.parameters()], losses]
        del params
        torch.cuda.empty_cache()


def timed_ms(torch, fn, runs: int = 3) -> tuple[list[float], object]:
    """Host-clock ms of ``fn()`` ended by a synchronize, ``runs`` times
    (the first warm); returns (the times, the last result)."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, out


def family_close(torch, label, got, want, rtol=FAMILY_RTOL,
                 atol=FAMILY_ATOL) -> float:
    """``allclose`` of the card's float32 output against the CPU's (or
    another path's); returns the max abs difference, raises beyond."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}, or not finite")
    err = (got - want).abs()
    if bool((err > atol + rtol * want.abs()).any()):
        raise AssertionError(f"{label}: max abs difference "
                             f"{float(err.max()):.3e} beyond rtol={rtol} "
                             f"atol={atol}")
    return float(err.max())


def topk_agree(torch, label, got, want, k: int = 10) -> int:
    """The card's top-k ids of a score vector against the CPU's: at each
    rank the CPU's score of the card's id equals the CPU's own (ids may
    differ only at ties). Returns the ranks whose ids differ."""
    want = want.double().cpu()
    g = torch.topk(got.double().cpu(), k).indices
    w = torch.topk(want, k).indices
    if bool(((want[g] - want[w]).abs()
             > FAMILY_ATOL + FAMILY_RTOL * want[w].abs()).any()):
        raise AssertionError(f"{label}: top-{k} ids differ from the CPU's "
                             "beyond ties")
    return int((g != w).sum())


def recsys_arch(torch, dev, seed, runtime, smi, arch) -> dict:
    """Phase 22 for one recsys arch at its full CONFIG: train_batch (3
    AdamW steps twice), serve_p99 (against the CPU), serve_bulk
    (examples/s) and retrieval_cand (latency; a 4,096-candidate slice
    against the CPU, fm's and sasrec's shortcut against the full
    scoring); sasrec then runs the Seismic bridge. Returns the kernel
    launches (the bridge's)."""
    import numpy as np
    from repro_torch.models.api import get_bundle
    bundle = get_bundle(arch)
    cfg, mod = bundle.config, family_module(bundle.config)
    cells = {c.name: c for c in bundle.shapes}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_arch = time.perf_counter()

    def batch_of(cell, seed_):
        c = cells[cell]
        return bundle.make_batch(np.random.default_rng(seed_), cfg, c.dims,
                                 c.kind, device=dev)

    train = batch_of("train_batch", seed)
    params, losses, after, times = family_train(
        torch, dev, bundle, cfg, {}, train, seed, f"22 {arch} train_batch",
        FAMILY_LR)
    n = sum(p.numel() for p in params.parameters())
    b = cells["train_batch"].dims["batch"]
    ms = float(np.mean(times[1:]))
    log(f"[22 {arch}] {cfg.name}, {cfg.interaction}, embed_dim "
        f"{cfg.embed_dim}: {n} parameters ({n * 4 / 2**30:.2f} GiB float32); "
        f"train_batch [{b}]: {FAMILY_STEPS} AdamW steps (lr {FAMILY_LR}) on "
        f"one repeated batch, losses {', '.join(f'{x:.6f}' for x in losses)}"
        f", then {after:.6f}; two runs from seed {seed} bitwise equal; ms a "
        f"step {', '.join(f'{t:.1f}' for t in times)} ({ms:.2f} after the "
        f"warm step, {b / ms * 1e3:.0f} examples/s); card {smi}")
    del train
    cpu_params = to_cpu(cfg, params)

    # serve_p99: the card against the port on the CPU, same parameters
    serve = bundle.step(cfg, {}, "serve")
    p99 = batch_of("serve_p99", seed + 1)
    times, got = timed_ms(torch, lambda: serve(params, p99))
    want = serve(cpu_params, {k: v.cpu() for k, v in p99.items()})
    err = family_close(torch, f"22 {arch} serve_p99 card vs CPU", got, want)
    log(f"  serve_p99 [{cells['serve_p99'].dims['batch']}]: ms "
        f"{', '.join(f'{t:.2f}' for t in times)}; card vs CPU (float32, "
        f"full width) max abs difference {err:.3e} (rtol {FAMILY_RTOL}, "
        f"atol {FAMILY_ATOL})")
    del p99, got, want

    # serve_bulk: examples/s
    bulk = batch_of("serve_bulk", seed + 2)
    nb = cells["serve_bulk"].dims["batch"]
    times, got = timed_ms(torch, lambda: serve(params, bulk))
    ms = float(np.mean(times[1:]))
    log(f"  serve_bulk [{nb}]: ms {', '.join(f'{t:.1f}' for t in times)}; "
        f"{nb / ms * 1e3:.0f} examples/s after the warm run; output "
        f"{tuple(got.shape)} finite {bool(torch.isfinite(got).all())}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"22 {arch} serve_bulk: not finite")
    del bulk, got

    # retrieval_cand: latency, a slice against the CPU, the shortcuts
    retrieve = bundle.step(cfg, {}, "retrieval")
    rb = batch_of("retrieval_cand", seed + 3)
    times, scores = timed_ms(torch, lambda: retrieve(params, rb))
    c = rb["cand"].shape[0]
    ms = float(np.mean(times[1:]))
    sl = {k: (v[:CPU_SLICE] if k == "cand" else v).cpu()
          for k, v in rb.items()}
    want = retrieve(cpu_params, sl)
    err = family_close(torch, f"22 {arch} retrieval slice card vs CPU",
                       scores[:CPU_SLICE], want)
    ranks = topk_agree(torch, f"22 {arch} retrieval slice",
                       scores[:CPU_SLICE], want)
    top = torch.topk(scores, 10)
    text = ""
    with torch.no_grad():
        if arch == "fm":
            ids = torch.cat([rb["cand"][:, None],
                             rb["ids"].expand(c, -1)], 1)
            full = mod.forward(params, ids, rb["dense"].expand(c, -1), cfg)
        elif arch == "sasrec":
            full = mod.serve_step(params, dict(seq=rb["seq"],
                                               cand=rb["cand"][None]), cfg)[0]
        else:
            full = None
    if full is not None:
        ferr = family_close(torch, f"22 {arch} shortcut vs full scoring",
                            scores, full, atol=FAMILY_SHORTCUT_ATOL)
        text = (f"; the [C, D] @ [D] shortcut against the full scoring of "
                f"all {c} candidates max abs difference {ferr:.3e}")
        del full
    log(f"  retrieval_cand [{c} candidates]: ms "
        f"{', '.join(f'{t:.1f}' for t in times)} ({ms:.1f} after the warm "
        f"run, {c / ms * 1e3:.3g} candidates/s); top-10 scores "
        f"{', '.join(f'{x:.4f}' for x in top.values.tolist())}; the first "
        f"{CPU_SLICE} candidates against the CPU: max abs difference "
        f"{err:.3e}, top-10 ranks with other ids (ties) {ranks}{text}")
    del rb, scores, want, top
    launches = {}
    if arch == "sasrec":
        launches = seismic_bridge(torch, dev, params, cfg, seed, runtime, smi)
    peak = check_peak(torch, dev, f"22 {arch}")
    del params, cpu_params
    torch.cuda.empty_cache()
    log(f"  {arch}: peak device memory {peak:.2f} GiB; "
        f"{time.perf_counter() - t_arch:.1f} s")
    return launches


def seismic_bridge(torch, dev, params, cfg, seed, runtime, smi) -> dict:
    """The SASRec -> Seismic bridge (``examples/recsys_retrieval.py``) at
    sasrec's full CONFIG: the padded item table as [relu(x); relu(-x)]
    (d = 2 x embed_dim), ``sparsify`` to BRIDGE_NNZ non-zeros, indexed by
    ``build_index`` with the example's knobs but lam BRIDGE_LAM; the last
    states of BRIDGE_USERS histories, sparsified the same way, searched by
    ``search_batch`` at the port's defaults with launch counts set to 0
    just before and read just after (summary_dot and gather_dot_cand
    asserted). Asserted: ids as the plain path's except at ties,
    ``docs_evaluated`` equal. Printed: the top-10 overlap with brute force
    over the dense table (no threshold). Returns the launches."""
    import numpy as np
    from repro_torch.core import (SearchParams, SeismicConfig, build_index,
                                  search_batch)
    from repro_torch.models.recsys import sasrec
    from repro_torch.sparse.ops import sparsify

    def nonneg(x):
        return torch.cat([x.clamp_min(0), (-x).clamp_min(0)], dim=1)

    table = params["item_emb"].detach()
    t0 = time.perf_counter()
    items = sparsify(nonneg(table), BRIDGE_NNZ)
    icfg = SeismicConfig(lam=BRIDGE_LAM, beta=8, alpha=0.5, block_cap=32,
                         summary_nnz=32)
    index = build_index(items, icfg, list_chunk=16)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 22)
    seqs = torch.from_numpy(rng.integers(
        1, cfg.n_items, (BRIDGE_USERS, cfg.seq_len)).astype(np.int32)).to(dev)
    with torch.no_grad():
        states = sasrec.forward(params, seqs, cfg)[:, -1]
    queries = sparsify(nonneg(states), BRIDGE_NNZ)
    p = SearchParams()
    search_batch(index, queries, p)                      # warm
    torch.cuda.synchronize()
    runtime.reset_launches()
    t0 = time.perf_counter()
    got = search_batch(index, queries, p)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(runtime.LAUNCHES)
    if not (launches["summary_dot"] and launches["gather_dot_cand"]):
        raise AssertionError(f"22 bridge launched {launches}: summary_dot "
                             "and gather_dot_cand expected")
    ref = search_batch(index, queries, SearchParams(use_kernel=False,
                                                    fuse_level=0))
    if not torch.equal(got[2].to(torch.int64), ref[2].to(torch.int64)):
        raise AssertionError("22 bridge: docs_evaluated differs from the "
                             "plain path's")
    rows = check_against_plain(torch, "22 bridge", (got[0], got[1]),
                               (ref[0], ref[1]), p.k)
    with torch.no_grad():
        brute = torch.topk(states @ table.T, p.k).indices
    overlap = np.mean([len(set(a) & set(b)) / p.k for a, b in
                       zip(got[1].tolist(), brute.tolist())])
    log(f"  [22 bridge] sasrec's item table {tuple(table.shape)} as "
        f"[relu(x); relu(-x)], {BRIDGE_NNZ} non-zeros a row, indexed in "
        f"{t_build:.1f} s (lam {BRIDGE_LAM}, beta 8, alpha 0.5, block_cap "
        f"32, summary_nnz 32: {icfg.n_blocks} blocks a list); "
        f"{BRIDGE_USERS} user states searched at the port's defaults in "
        f"{ms:.2f} ms; launches { {k: v for k, v in launches.items() if v} };"
        f" ids as the plain path's (rows differing at ties {rows}), "
        f"docs_evaluated equal (mean "
        f"{float(got[2].float().mean()):.1f} of {table.shape[0]} items); "
        f"top-10 overlap with brute force over the dense table "
        f"{overlap:.4f}; card {smi}")
    del index, items, queries, got, ref, brute, states
    return launches


def recsys_phase(torch, dev, seed, runtime, smi) -> dict:
    """Phase 22: fm, wide-deep, sasrec and bst at their full CONFIGs.
    Returns the kernel launches (the bridge's)."""
    t0 = time.perf_counter()
    launches = {}
    for arch in RECSYS_ARCHS:
        for name, n in recsys_arch(torch, dev, seed, runtime, smi,
                                   arch).items():
            launches[name] = launches.get(name, 0) + n
    log(f"  phase 22 in {time.perf_counter() - t0:.1f} s")
    return launches


def aggregate_check(torch, dev, gin, feats, edges, seed) -> str:
    """gin's aggregate of the features at GNN_CHECK_NODES sampled nodes
    against float64 sums on the host: each within ``n * 2**-24 *
    sum|terms|`` (float32 sums of n terms, in any order)."""
    import numpy as np
    n = feats.shape[0]
    with torch.no_grad():
        agg = gin._aggregate(feats, edges, n)
    nodes = np.random.default_rng(seed).choice(n, GNN_CHECK_NODES,
                                               replace=False)
    e = edges.cpu().numpy()
    picked = np.zeros(n, bool)
    picked[nodes] = True
    keep = picked[e[:, 1]]
    src, dst = e[keep, 0], e[keep, 1]
    f = feats.cpu().numpy().astype(np.float64)
    pos = np.full(n, -1)
    pos[nodes] = np.arange(nodes.size)
    want = np.zeros((nodes.size, f.shape[1]))
    mass = np.zeros_like(want)
    np.add.at(want, pos[dst], f[src])
    np.add.at(mass, pos[dst], np.abs(f[src]))
    deg = np.bincount(pos[dst], minlength=nodes.size)[:, None]
    got = agg[torch.from_numpy(nodes).to(dev)].double().cpu().numpy()
    err = np.abs(got - want)
    bound = deg * 2.0 ** -24 * mass + 1e-30
    if (err > bound).any():
        raise AssertionError(f"23 ogb_products aggregate: "
                             f"{int((err > bound).sum())} elements beyond "
                             "n 2^-24 sum|terms|")
    return (f"the aggregate at {nodes.size} sampled nodes (in-degree "
            f"{int(deg.min())}-{int(deg.max())}) against float64 sums on the "
            f"host: max abs difference {err.max():.3e}, at most "
            f"{float((err / bound).max()):.3f} of the bound n 2^-24 "
            "sum|terms|")


def gnn_card_vs_cpu(torch, bundle, cfg, dims, batch, params, label) -> str:
    """Step 0's gradients of the card and the CPU from the same
    parameters and batch, per leaf within ``GNN_GRAD_ATOL`` of its
    largest element; then FAMILY_STEPS steps on each, losses within
    ``rtol`` 1e-4 and every parameter within ``lr * n / 4`` (GNN_LR).
    ``params`` are the parameters as drawn (not stepped)."""
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
    loss_fn = bundle.step(cfg, dims, "train")
    cpu_params = to_cpu(cfg, params)           # before the card's steps
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    sides = {}
    for where, p, b in (("card", params, batch),
                        ("cpu", cpu_params, cpu_batch)):
        named = dict(p.named_parameters())
        grads = torch.autograd.grad(loss_fn(p, b), list(named.values()))
        grads = [g.cpu() for g in grads]
        step_fn = make_train_step(loss_fn, AdamWConfig(
            lr=GNN_LR, warmup_steps=1, total_steps=100))
        opt = init_opt_state(p)
        losses = []
        for _ in range(FAMILY_STEPS):
            p, opt, m = step_fn(p, opt, b)
            losses.append(float(m["loss"]))
        sides[where] = (grads, losses, [x.detach().cpu()
                                        for x in p.parameters()])
    (gc_, lc, pc), (gg, lg, pg) = sides["cpu"], sides["card"]
    gerr = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(gg, gc_))
    rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    worst = max(float((a - b).abs().max()) for a, b in zip(pg, pc))
    if gerr > GNN_GRAD_ATOL or rel > 1e-4 \
            or worst > 0.25 * GNN_LR * FAMILY_STEPS:
        raise AssertionError(f"{label}: card and CPU differ beyond the bound "
                             f"(gradients {gerr:.2e} of the leaf's largest, "
                             f"losses {rel:.2e}, parameters {worst:.2e})")
    return (f"card vs CPU: step 0's gradients within {gerr:.2e} of each "
            f"leaf's largest, losses card {', '.join(f'{x:.6f}' for x in lg)}"
            f" CPU {', '.join(f'{x:.6f}' for x in lc)} (max rel {rel:.2e}), "
            f"parameters max |diff| {worst:.2e} = "
            f"{worst / GNN_LR:.4f} lr")


def gnn_phase(torch, dev, seed, smi) -> None:
    """Phase 23: gin-tu at its CONFIG over the four GNN_SHAPES cells
    through ``make_batch`` (3 steps twice, bitwise; full_graph_sm and
    molecule against the CPU; ogb_products' forward and its aggregate
    against float64 host sums), then one step on a batch drawn by
    ``sample_subgraph`` from ``random_graph`` at minibatch_lg's nodes
    with a tenth of its edges."""
    import numpy as np
    from repro_torch.data.pipeline import random_graph
    from repro_torch.models.api import get_bundle
    from repro_torch.models.gnn import gin
    from repro_torch.models.gnn.sampler import CSRGraph, sample_subgraph
    bundle = get_bundle("gin-tu")
    cfg = bundle.config
    t_phase = time.perf_counter()
    for cell in bundle.shapes:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t_cell = time.perf_counter()
        dims = cell.dims
        t0 = time.perf_counter()
        batch = bundle.make_batch(np.random.default_rng(seed), cfg, dims,
                                  cell.kind, device=dev)
        t_batch = time.perf_counter() - t0
        shapes = {k: tuple(v.shape) for k, v in batch.items()}
        extra = ""
        if cell.name == "ogb_products":
            params = bundle.init(seed, cfg, dims, device=dev)
            with torch.no_grad():
                times, h = timed_ms(torch, lambda: gin.forward(
                    params, batch["feats"], batch["edges"], cfg), runs=2)
            agg = aggregate_check(torch, dev, gin, batch["feats"],
                                  batch["edges"], seed)
            extra = (f"; forward (no autograd) ms "
                     f"{', '.join(f'{t:.1f}' for t in times)}; {agg}")
            del params, h
        if cell.name in ("full_graph_sm", "molecule"):
            params = bundle.init(seed, cfg, dims, device=dev)
            extra = "; " + gnn_card_vs_cpu(torch, bundle, cfg, dims, batch,
                                           params, f"23 gin-tu {cell.name}")
            del params
        params, losses, after, times = family_train(
            torch, dev, bundle, cfg, dims, batch, seed,
            f"23 gin-tu {cell.name}", GNN_LR)
        peak = check_peak(torch, dev, f"23 gin-tu {cell.name}")
        log(f"[23 gin-tu {cell.name}] {cfg.n_layers} layers, d_hidden "
            f"{cfg.d_hidden}, batch {shapes} (made in {t_batch:.1f} s): "
            f"{FAMILY_STEPS} AdamW steps (lr {GNN_LR}), losses "
            f"{', '.join(f'{x:.6f}' for x in losses)}, then {after:.6f}; "
            f"two runs bitwise equal; ms a step "
            f"{', '.join(f'{t:.1f}' for t in times)}; peak device memory "
            f"{peak:.2f} GiB{extra}; {time.perf_counter() - t_cell:.1f} s; "
            f"card {smi}")
        del params, batch
    # a batch drawn by the sampler from a community graph
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    d = {c.name: c.dims for c in bundle.shapes}["minibatch_lg"]
    n_edges = d["n_edges"] // GRAPH_EDGE_CUT
    t0 = time.perf_counter()
    g = random_graph(d["n_nodes"], n_edges, d["d_feat"], d["n_classes"],
                     seed=seed)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    csr = CSRGraph(d["n_nodes"] + 1, g["edges"].astype(np.int64))
    rng = np.random.default_rng(seed)
    seeds = rng.choice(d["n_nodes"], d["batch_nodes"], replace=False)
    sub = sample_subgraph(rng, csr, seeds, tuple(d["fanout"]), g["feats"],
                          g["labels"])
    t_sample = time.perf_counter() - t0
    batch = {k: torch.from_numpy(v).to(dev) for k, v in sub.items()}
    real_edges = int((sub["edges"][:, 0] != sub["feats"].shape[0] - 1).sum())
    params, losses, after, times = family_train(
        torch, dev, bundle, cfg, d, batch, seed, "23 gin-tu sampled batch",
        GNN_LR)
    peak = check_peak(torch, dev, "23 gin-tu sampled batch")
    log(f"[23 gin-tu sampled] random_graph({d['n_nodes']} nodes, {n_edges} "
        f"edges: a tenth of minibatch_lg's, mean in-degree "
        f"{n_edges / d['n_nodes']:.1f}) in {t_graph:.1f} s; CSRGraph and "
        f"sample_subgraph ({d['batch_nodes']} seeds, fanout "
        f"{tuple(d['fanout'])}) in {t_sample:.1f} s: "
        f"{ {k: v.shape for k, v in sub.items()} }, {real_edges} sampled "
        f"edges; {FAMILY_STEPS} steps twice bitwise, losses "
        f"{', '.join(f'{x:.6f}' for x in losses)}, then {after:.6f}; ms a "
        f"step {', '.join(f'{t:.1f}' for t in times)}; peak {peak:.2f} GiB")
    del params, batch, g, csr, sub
    torch.cuda.empty_cache()
    log(f"  phase 23 in {time.perf_counter() - t_phase:.1f} s")


def family_phases(torch, dev, seed, runtime, smi) -> dict:
    """Phases 22 and 23; returns phase 22's kernel launches."""
    launches = recsys_phase(torch, dev, seed, runtime, smi)
    gnn_phase(torch, dev, seed, smi)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=1 << 20,
                    help="collection size (MS MARCO has 8,841,823)")
    ap.add_argument("--seed", type=int, default=0)
    # phase 15 starts this script again as the ranks of its
    # make_distributed_search run
    ap.add_argument("--shard-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--out", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if args.shard_rank is not None:
        return shard_rank(args)
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
    if any(TUNED[k] != v for k, v in TUNED_LITERAL.items()):
        raise AssertionError(f"from_tuned(CONFIG_TUNED, 0.95) gives {TUNED}, "
                             f"not the served point {TUNED_LITERAL}")
    log(f"  TUNED = from_tuned(CONFIG_TUNED, 0.95): {TUNED}")

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

    # ---- 14. the recall-target tuner on phase 7's index
    tuned = tuning_phase(torch, dev, args, runtime, smi, kept)
    for rec in record:
        rec["launches"] += tuned[rec["name"]]

    # ---- 12. the mutation path on phase 7's index
    mutated = mutation_phase(torch, dev, args, runtime, smi,
                             kept.pop("index"), kept["queries"])
    for rec in record:
        rec["launches"] += mutated[rec["name"]]
    gc.collect()                  # the index and the graph go here
    torch.cuda.empty_cache()

    # ---- 15. doc-sharded search three ways, the paper's baselines
    sharded = sharded_phase(torch, dev, args, runtime, smi, kept)
    for rec in record:
        rec["launches"] += sharded[rec["name"]]
    kept.clear()
    torch.cuda.empty_cache()

    # ---- 9. the LM path: flash_attention against plain, prefill, serving
    lm_records = lm_phases(torch, dev, args.seed, runtime)
    record.extend(lm_records)
    torch.cuda.empty_cache()

    # ---- 16-18. gemma3-27b, deepseek-v2-lite-16b, kimi-k2-1t-a32b
    lm_family_phases(torch, dev, args.seed, runtime, lm_records)
    torch.cuda.empty_cache()

    # ---- 19. Seismic's serving CLI
    cli = cli_phase(torch, dev, runtime)
    for rec in record:
        rec["launches"] += cli.get(rec["name"], 0)
    torch.cuda.empty_cache()

    # ---- 20-21. LM training on one card
    train_phases(torch, dev, args.seed, smi)
    torch.cuda.empty_cache()

    # ---- 22-23. the recsys and GNN families at full width
    families = family_phases(torch, dev, args.seed, runtime, smi)
    for rec in record:
        rec["launches"] += families.get(rec["name"], 0)
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": record}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
