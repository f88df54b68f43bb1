#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--n-docs N] [--seed S]

Run from the repository root; needs one CUDA device and ``nvcc``. Phases:

1. device: name, count, ``nvidia-smi`` name and power limit; TF32 off for
   float32 matmuls and convolutions, so every reference is full float32;
2. build the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` (one
   ``nvcc`` each, in parallel) and print ptxas' register/spill report;
3. each kernel against its plain PyTorch version at the slice's shapes
   (Q = 256, L = 4940, S = 96; N = 4096 and 512; nnz = 128;
   d = 30522), in f32, bf16, and u8 values with u16 coords;
4. the collection and the index at the MS MARCO widths of
   ``configs/seismic_msmarco.py`` (d = 30522, 128 nnz per doc, 48 per
   query; lam 6000, beta 400, alpha 0.4, block_cap 64, 96-entry
   summaries, bf16 forward index), ``--n-docs`` documents (the only cut);
5. the main path: ``SeismicServer`` answers 256 queries and
   ``search_pipeline`` a 4096-query batch, at kernel fuse levels 0 and 1,
   with launch counts set to 0 just before and read just after; the
   plain path (``use_kernel=False``) is the reference at 256; recall@10
   against the exact top-10 on the card; per-stage times;
6. each kernel timed on the main path's own inputs with CUDA events
   (L2 flushed before every launch) beside its bound, its plain version
   and one PyTorch library call where one computes the same function.

The last lines are the kernels' JSON record, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero; nothing falls back to the CPU or the plain versions.

Tolerance, kernel against plain: ``|k - p| <= 2e-5 * |p| + 1e-6``. Both
sum at most 128 nonnegative float32 products in different orders (the
kernel also fuses the dequant multiply-add); each order is within
128 * 2^-24 ~ 7.6e-6 relative of the exact sum, so two orders differ by
less than 1.6e-5.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RTOL, ATOL = 2e-5, 1e-6
# the slice's shapes: MS MARCO widths (configs/seismic_msmarco.py) and
# its two query batches; router L = cut * n_blocks = 10 * 494
DIM, DOC_NNZ, QUERY_NNZ = 30522, 128, 48
Q_ONLINE, Q_BATCH, CUT, BLOCK_BUDGET = 256, 4096, 10, 64
INDEX = dict(lam=6000, beta=400, alpha=0.4, block_cap=64, summary_nnz=96,
             fwd_dtype="bfloat16")
ROUTER_L, SUMMARY_S, SCORER_N, STAGE1_N = 4940, 96, 4096, 512
PLANE_DOCS = 1 << 20
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
}


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
    if bool((err > RTOL * w.abs() + ATOL).any()):
        raise AssertionError(f"{name}: max abs err {abs_err:.3e}, max rel "
                             f"err {rel_err:.3e} beyond rtol={RTOL} "
                             f"atol={ATOL}")
    return abs_err, rel_err


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def synthetic_phase(torch, dev, gen) -> None:
    """Phase 3: every kernel variant against its plain version at the
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
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.build import build_index
    from repro_torch.core.oracle import exact_topk, mean_recall_at_k
    from repro_torch.core.types import SeismicConfig
    from repro_torch.data import SyntheticSparseConfig, make_collection
    from repro_torch.kernels import runtime
    from repro_torch.kernels.gather_dot.ops import (
        cand_tiles_processed, gather_dot_batch, gather_dot_batch_ref,
        gather_dot_cand_batch, gather_dot_cand_ref)
    from repro_torch.kernels.summary_dot.ops import (summary_dot_batch,
                                                     summary_dot_batch_ref)
    from repro_torch.retrieval import (SearchParams, run_pipeline_staged,
                                       search_pipeline)
    from repro_torch.retrieval.prep import prep_queries
    from repro_torch.serve import SeismicServer
    from repro_torch.sparse.ops import take_rows
    from repro_torch.sparse.quant import dequantize_u8

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

    # ---- 3. kernels against plain, synthetic inputs at the slice's shapes
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    synthetic_phase(torch, dev, gen)
    log(f"[3 kernels vs plain] all variants within rtol={RTOL} atol={ATOL} "
        f"in {time.perf_counter() - t0:.1f} s")

    # ---- 4. collection and index at the MS MARCO widths
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    data_cfg = SyntheticSparseConfig(dim=DIM, n_docs=args.n_docs,
                                     n_queries=Q_BATCH, doc_nnz=DOC_NNZ,
                                     query_nnz=QUERY_NNZ, seed=args.seed)
    docs, queries, _ = make_collection(data_cfg, device=dev)
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    icfg = SeismicConfig(**INDEX, seed=args.seed)
    timings: dict[str, float] = {}
    t0 = time.perf_counter()
    index = build_index(docs, icfg, timings=timings)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    log(f"[4 index] {args.n_docs} docs (MS MARCO: 8841823), d={DIM}, "
        f"collection {t_data:.1f} s, build {t_build:.1f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in timings.items()))
    log(f"  index bytes {json.dumps(index.nbytes())}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
        f"n_blocks {icfg.n_blocks}; live blocks "
        f"{int((index.block_len > 0).sum())}")

    # ---- 5. the main path
    q256, q4096 = queries[:Q_ONLINE], queries
    base = dict(k=10, cut=CUT, block_budget=BLOCK_BUDGET)
    plain = SearchParams(use_kernel=False, fuse_level=0, **base)
    ref256 = search_pipeline(index, q256, plain)
    levels = {0: SearchParams(use_kernel=True, fuse_level=0, **base),
              1: SearchParams(use_kernel=True, fuse_level=1, **base)}
    results, batch_ms = {}, {}
    torch.cuda.synchronize()
    runtime.reset_launches()
    for fuse, p in levels.items():
        server = SeismicServer(index, p, max_batch=Q_ONLINE)
        for label, run in (("server 256", lambda: server.search(q256)),
                           ("pipeline 4096",
                            lambda: search_pipeline(index, q4096, p))):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            results[fuse, label] = out
            batch_ms[fuse, label] = times
    launches = dict(runtime.LAUNCHES)
    log(f"[5 main path] launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    for label in ("server 256", "pipeline 4096"):
        r0, r1 = results[0, label], results[1, label]
        a = (r0.scores, r0.ids, r0.docs_evaluated) \
            if label.startswith("server") else r0
        b = (r1.scores, r1.ids, r1.docs_evaluated) \
            if label.startswith("server") else r1
        if not (torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])):
            raise AssertionError(f"{label}: ids or docs_evaluated differ "
                                 "between fuse levels 0 and 1")
        log(f"  {label}: fuse 0 ms {['%.1f' % t for t in batch_ms[0, label]]}"
            f", fuse 1 ms {['%.1f' % t for t in batch_ms[1, label]]}; ids and "
            f"docs_evaluated equal across levels, scores bitwise equal: "
            f"{torch.equal(a[0], b[0])}; mean docs_evaluated "
            f"{float(b[2].float().mean()):.1f}")
    k256 = results[1, "server 256"]
    compare(torch, "main path scores vs plain", k256.scores, ref256[0])
    diff_rows = int((k256.ids != ref256[1]).any(dim=1).sum())
    for q, i in (k256.ids != ref256[1]).nonzero().tolist():
        s = ref256[0][q].double()
        near = (s - s[i]).abs() <= ATOL + RTOL * abs(float(s[i]))
        if int(near.sum()) < 2 and i != base["k"] - 1:
            raise AssertionError(f"query {q}: ids differ from the plain path "
                                 f"at an isolated score")
    log(f"  kernel path vs plain path at {q256.n}: scores within tolerance, "
        f"{diff_rows} rows with ids differing at non-isolated ties")
    t0 = time.perf_counter()
    ex_s, ex_i = exact_topk(docs.coords, docs.vals, docs.dim, q256.coords,
                            q256.vals, 10)
    torch.cuda.synchronize()
    log(f"  recall@10 vs exact top-10 ({q256.n} queries, exact in "
        f"{time.perf_counter() - t0:.1f} s): kernel path "
        f"{mean_recall_at_k(k256.ids, ex_i):.4f}, plain path "
        f"{mean_recall_at_k(ref256[1], ex_i):.4f}")
    for fuse, p in levels.items():
        for qs in (q256, q4096):
            stages: dict[str, float] = {}
            run_pipeline_staged(index, qs.coords, qs.vals, p,
                                record=stages.__setitem__)
            run_pipeline_staged(index, qs.coords, qs.vals, p,
                                record=stages.__setitem__)
            log(f"  stages ms, fuse {fuse}, Q={qs.n}: "
                + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in stages.items()))

    # ---- 6. kernels on the main path's inputs: errors and times
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
    l_, n_, nnz = a_in[1].shape[1], cand0.shape[1], index.fwd.coords.shape[1]
    vb, cb = index.fwd.vals.element_size(), index.fwd.coords.element_size()
    bounds = {
        "summary_dot": bound(qn * l_ * s * 5 + qn * l_ * 12
                             + q_dense.nbytes, 4 * qn * l_ * s),
        "gather_dot": bound(qn * n_ * nnz * (vb + cb) + qn * n_ * 4
                            + q_dense.nbytes, 2 * qn * n_ * nnz),
        "gather_dot_cand": bound(n_rows * nnz * (vb + cb) + qn * n_ * 8
                                 + q_dense.nbytes, 2 * n_live * nnz),
    }

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
    }
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
        log(f"[6 {name}] {ms:.4f} ms (bound {bms:.4f} ms by {by}, "
            f"{bms / ms:.1%} of it), plain {plain_ms:.3f} ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; max abs "
            f"err {abs_err:.3e}, rel {rel_err:.3e}")
    log(f"  gather_dot_cand: {n_live} live (query, candidate) pairs of "
        f"{cand1.numel()} over {n_rows} distinct documents (the rows its "
        f"bound counts), {int(tiles.sum())} of {tiles.numel()} tiles "
        "processed")
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": record}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
