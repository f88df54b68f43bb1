#!/usr/bin/env python3
"""Time the scorer's candidate kernel (block_cand) and its sort variants
on one GPU.

    python3 scripts/block_cand_times.py [--parent DIR]

Run from the repository root on a machine with one CUDA device and
``nvcc``. On a synthetic index at MS MARCO's shapes (30,522 lists of 494
block slots, up to 6,000 ids a list in blocks of up to 64, nine blocks
in ten full, ids below 8,841,823) it draws each query's probed lists
(cut 10) and its selected blocks (the top B of random router scores
over the lists' non-empty blocks, a strided view, as the selectors pass
them) and times with ``chip_smoke.Bench`` (L2 flushed before each
launch), in two rounds, at 256 and 4,096 queries and C = 512, 4,096 and
8,192 ids a query (B = 8, 64 and 128 blocks of 64):

* as built: the bitonic sort of ``block_sort.cuh`` (refine_fused.cu's
  block route's);
* radix: a patched copy of ``block_cand.cu`` whose sort is an LSD radix
  sort of the ids, 8 bits a pass over the bits of n_docs (3 passes below
  2^24), each warp ranking its own chunk in order by a match of equal
  digits, 32 ids at a time, the warps' counts by digit scanned across
  the block; it needs a second buffer of shared memory, so its cap is
  cut to 16,384 ids;
* 32 warps at 8,192: blocks of 32 warps (1,024 threads) from 8,192 sort
  keys up, where the kernel takes 16;
* torch: the scorer's torch operations at fuse level 1 before the kernel
  (``block_candidates_ref`` on the card: gather, masks, two sorts).

A patch replaces text that must occur in the source exactly once;
copies are compiled under ``build/variants/`` with the runtime's nvcc
flags and called through ctypes. Each variant's ids must equal the
torch operations'. It prints the card, each kernel's ptxas line, and
for each shape the times, the live ids a query and the byte bound
(what the kernel must read and write over 3.35 TB/s). With ``--parent``
it also compiles the refine_fused.cu of the checkout at DIR beside this
one's and prints refine_block_kernel's ptxas lines of both, which must
be equal (the shared header moved code, not behaviour).
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "variants"
HBM_BYTES_PER_S = 3.35e12
N_DOCS, N_LISTS, LAM, CAP, CUT = 8841823, 30522, 6000, 64, 10
SHAPES = [(qn, b) for qn in (256, 4096) for b in (8, 64, 128)]

# the radix variant's sort (a second buffer of P ids after the marks)
RADIX_SORT = r'''
// LSD radix sort of key[0, n) over its low `bits` bits, 8 a pass, through
// tmp[0, n); returns where the sorted ids lie (key or tmp). Each warp ranks
// the ids of its own chunk in order, 32 at a time (a match of equal
// digits); the warps' counts are scanned across the block in (digit, warp)
// order, so every pass is stable. The caller syncs the block before.
template <int kWarps>
__device__ int* radix_sort(int* key, int* tmp, int n, int bits) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kPer = 256 * kWarps / kThreads;   // counts a thread scans
  __shared__ int count[kWarps * 256];            // [warp][digit]
  __shared__ int wsum[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = ((n + kWarps - 1) / kWarps + 31) & ~31;
  const int lo = min(n, warp * chunk), hi = min(n, lo + chunk);
  for (int shift = 0; shift < bits; shift += 8) {
    for (int i = threadIdx.x; i < kWarps * 256; i += kThreads) count[i] = 0;
    __syncthreads();
    // each warp counts its chunk's digits (lanes past it match nothing)
    for (int g = lo; g < hi; g += 32) {
      const int t = g + lane;
      const bool on = t < hi;
      const int d = on ? (key[t] >> shift) & 255 : 256 + lane;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (on && lane == __ffs(peers) - 1)
        count[warp * 256 + d] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // the counts' exclusive scan in (digit, warp) order: kPer a thread,
    // the threads' sums scanned within and across warps
    int c[kPer], sum = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int x = threadIdx.x * kPer + e;
      c[e] = count[(x % kWarps) * 256 + x / kWarps];
      sum += c[e];
    }
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == 31) wsum[warp] = inc;
    __syncthreads();
    int run = inc - sum;
    for (int w = 0; w < warp; ++w) run += wsum[w];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int x = threadIdx.x * kPer + e;
      count[(x % kWarps) * 256 + x / kWarps] = run;
      run += c[e];
    }
    __syncthreads();
    // each id to its digit's next place, in the chunk's order
    for (int g = lo; g < hi; g += 32) {
      const int t = g + lane;
      const bool on = t < hi;
      const int v = on ? key[t] : 0;
      const int d = on ? (v >> shift) & 255 : 256 + lane;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      const int at = on ? count[warp * 256 + d] : 0;
      if (on) tmp[at + __popc(peers & ((1u << lane) - 1u))] = v;
      __syncwarp();
      if (on && lane == __ffs(peers) - 1)
        count[warp * 256 + d] = at + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    int* x = key;
    key = tmp;
    tmp = x;
  }
  return key;
}

template <int kWarps>
__global__ void'''

VARIANTS = {
    "as built": [],
    "radix": [
        ("constexpr int kMaxCand = 32768;", "constexpr int kMaxCand = 16384;"),
        ("constexpr int smem_bytes(int keys) { return keys * 4 + keys / 8 + "
         "16; }",
         "constexpr int smem_bytes(int keys) { return keys * 8 + keys / 8 + "
         "16; }"),
        ("\ntemplate <int kWarps>\n__global__ void", "\n" + RADIX_SORT),
        ("  block_sort<kWarps>(key, P);\n  __syncthreads();\n",
         "  key = radix_sort<kWarps>(key, smem + P + P / 32 + 4, n_cand,\n"
         "                           32 - __clz(n_docs));\n")],
    "32 warps at 8,192": [
        ("int warps_for(int keys) { return keys <= 1024 ? 4 : (keys <= 2048 ? "
         "8 : 16); }",
         "int warps_for(int keys) { return keys <= 1024 ? 4 : (keys <= 2048 ? "
         "8 : (keys <= 4096 ? 16 : 32)); }"),
        ("  return launch<16>(BLOCK_CAND_ARGS);",
         "  if (warps == 16) return launch<16>(BLOCK_CAND_ARGS);\n"
         "  return launch<32>(BLOCK_CAND_ARGS);")],
}


def build(runtime, name: str, patches) -> subprocess.Popen:
    src = runtime.SOURCES["block_cand"].read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"block_cand / {name}: the text to patch is "
                               f"not in the source exactly once: "
                               f"{old[:60]!r}")
        src = src.replace(old, new)
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)
    path = OUT / f"block_cand_{tag}.cu"
    path.write_text(src)
    return subprocess.Popen(
        [runtime._nvcc(), *runtime.NVCC_FLAGS, "-o",
         str(path.with_suffix(".so")), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(name: str) -> ctypes.CDLL:
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)
    lib = ctypes.CDLL(str(OUT / f"block_cand_{tag}.so"))
    v, i = ctypes.c_void_p, ctypes.c_int
    lib.block_cand_launch.argtypes = ([v, i, v, i, v, i] + [v] * 5
                                      + [i] * 7 + [v])
    lib.block_cand_launch.restype = i
    return lib


def refine_ptxas(runtime, cs, root: Path, tag: str) -> list[str]:
    """refine_block_kernel's ptxas lines of the refine_fused.cu under
    ``root``, compiled with its own shared headers."""
    src = root / "src/repro_torch/kernels/refine_fused/csrc/refine_fused.cu"
    inc = src.parents[2] / "common" / "csrc"
    flags = list(runtime.NVCC_FLAGS)
    flags[flags.index("-I") + 1] = str(inc)
    out = OUT / f"refine_fused_{tag}.so"
    r = subprocess.run([runtime._nvcc(), *flags, "-o", str(out), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{src}: nvcc failed\n{r.stdout}{r.stderr}")
    return [line for line in cs.ptxas_lines(r.stdout + r.stderr)
            if line.startswith("refine_block_kernel")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose refine_fused.cu's ptxas lines "
                         "to compare")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("block_cand_times: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import runtime
    from repro_torch.kernels.block_cand.ref import block_candidates_ref

    print(f"[block_cand] {cs.nvidia_smi_name_power()}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {n: build(runtime, n, p) for n, p in VARIANTS.items()}
    if args.parent is not None:
        mine = refine_ptxas(runtime, cs, ROOT, "this")
        theirs = refine_ptxas(runtime, cs, args.parent.resolve(), "parent")
        for a, b in zip(mine, theirs):
            print(f"[block_cand] ptxas this:   {a}\n"
                  f"[block_cand] ptxas parent: {b}", flush=True)
        print(f"[block_cand] refine_block_kernel's ptxas lines equal: "
              f"{mine == theirs and len(mine) > 0}", flush=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        for line in cs.ptxas_lines(log):
            print(f"[block_cand] {name}: {line}", flush=True)
    libs = {n: load(n) for n in VARIANTS}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    nb = 400 + -(-LAM // CAP)                     # beta + lam / cap
    full = torch.rand((N_LISTS, nb), generator=gen, device=dev) < 0.9
    ln = torch.where(full, CAP, torch.randint(
        0, CAP, (N_LISTS, nb), generator=gen, device=dev)).to(torch.int32)
    ln = torch.where(torch.cumsum(ln, 1) <= LAM, ln, 0).to(torch.int32)
    off = (torch.cumsum(ln, 1) - ln).to(torch.int32)
    docs = torch.randint(0, N_DOCS, (N_LISTS, LAM), generator=gen,
                         device=dev, dtype=torch.int32)
    bench = cs.Bench(torch, dev)
    stream = runtime.stream_of(docs)
    lines: dict[str, list[float]] = {}
    for qn, b in SHAPES:
        lists = torch.randint(0, N_LISTS, (qn, CUT), generator=gen,
                              device=dev, dtype=torch.int32)
        coord = lists.long()[:, :, None].expand(qn, CUT, nb)
        r = torch.rand((qn, CUT, nb), generator=gen, device=dev)
        r = torch.where(ln[coord, torch.arange(nb, device=dev)] > 0, r,
                        -torch.inf).reshape(qn, CUT * nb)
        scores, blocks = torch.sort(r, dim=1, descending=True)
        scores, blocks = scores[:, :b], blocks[:, :b]
        want = block_candidates_ref(blocks, lists, off, ln, docs, scores,
                                    None, N_DOCS, CAP)
        live = float((want < N_DOCS).sum()) / qn
        coord = lists.long().gather(1, blocks // nb)
        gathered = float(ln[coord, blocks % nb].sum())
        # blocks' row, lists, offset, length, score a block; the live
        # slots' ids; cand written
        nbytes = qn * b * (8 + 4 + 4 + 4 + 4) + 4 * gathered + 4 * qn * b * CAP
        label = f"Q={qn} C={b * CAP}"
        print(f"[block_cand] {label}: {live:.1f} live ids a query of "
              f"{gathered / qn:.1f} gathered; bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
              f"({nbytes / 1e6:.1f} MB)", flush=True)
        cand = torch.empty((qn, b * CAP), dtype=torch.int32, device=dev)
        call = [runtime.ptr(blocks), blocks.stride(0), runtime.ptr(scores),
                scores.stride(0), runtime.ptr(lists), lists.stride(0),
                runtime.ptr(off), runtime.ptr(ln), runtime.ptr(docs),
                runtime.ptr(None), runtime.ptr(cand), qn, b, nb, CAP, LAM,
                N_DOCS, 0, stream]
        for _ in range(2):
            for name, lib in libs.items():
                cand.fill_(-7)
                fn = lambda lib=lib: runtime.check_launch(  # noqa: E731
                    lib.block_cand_launch(*call), name)
                lines.setdefault(f"{label} {name}", []).append(
                    bench.ms(fn, iters=20))
                if not torch.equal(cand, want):
                    raise AssertionError(f"{label} {name}: ids differ from "
                                         f"the torch operations'")
            lines.setdefault(f"{label} torch", []).append(bench.ms(
                lambda: block_candidates_ref(blocks, lists, off, ln, docs,
                                             scores, None, N_DOCS, CAP),
                iters=20))
        del want, cand, r
    for label, ms in lines.items():
        print(f"[block_cand] {label}: " + ", ".join(f"{t:.4f}" for t in ms)
              + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
