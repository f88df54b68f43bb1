// refine_fused.cu: one fused kNN-graph refine round, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/refine_fused/refine_fused.py,
// _refine_round_kernel launched by refine_round_pallas. Per query it
//
//   1. expands the graph neighbours of the current top-k:
//      knn[ids[q, i], :degree] for i < k, the sentinel n_docs where
//      ids[q, i] < 0, giving C = k * degree ids;
//   2. sorts them and masks duplicates (an id equal to its left
//      neighbour) to the sentinel;
//   3. masks every id found in scored[q, :W] (the ids scored in earlier
//      rounds and by the original merge) to the sentinel;
//   4. sorts again, so the live frontier is a sorted prefix (the
//      compaction of fuse level 1);
//   5. scores each live id exactly against the forward plane, f32 or bf16
//      values, or u8 levels with per-document (scale, zero), int32 or
//      uint16 coordinates; sentinels score -inf.
//
// It writes cand [Q, C] and scores [Q, C].
//
// Bound on an H100: bytes, and small. It reads the degree * 4 bytes of
// knn ids of each distinct top-k id, each query's scored row and k ids;
// once per distinct live candidate document one forward row of
// nnz * (value + coordinate) bytes (768 B for bf16 values and int32
// coordinates at nnz 128); the q entries those rows name; and writes
// both outputs. Operations: 2 per scored entry. At k 10, degree 8 and
// 256 queries that is 5.4 MB, 1.6 us at 3.35 TB/s: below a launch's own
// latency (an empty kernel, timed alike, takes about 5 us), so the
// kernel's time is its chain of dependent steps.
//
// Two routes, by C (refine_route below; ops.route in Python holds the
// same constants):
//
// The warp route, C <= kWarpMaxCand = 512: the chain kept short. The
// first design, one block per query sorting in shared memory (two
// bitonic sorts of 28 steps, each behind a __syncthreads), scanning the
// seen row serially per entry and rescoring about 10 candidates one after
// another per warp, each a row dot whose q lookups wait on its row's
// loads, took 20x its bound. Here one block of kWarps warps takes one
// query:
// * warp 0 holds the C <= 32 * KPL ids in registers, KPL a lane (padding
//   INT_MAX sorts last), and sorts them by a bitonic network over
//   __shfl_xor_sync with no block barrier; the left neighbour of a lane's
//   first id comes by __shfl_up_sync;
// * the seen row is loaded once, coalesced, at the kernel's start, and
//   each of its ids is broadcast to the warp and tested against every
//   lane's ids;
// * after the second sort (the compaction) the block's warps split the
//   live frontier, kRows candidates a warp at once, and load all their
//   entries (kAhead per lane and row) before any q lookup (row_dots), so
//   a query's row reads are in flight together.
//
// The block route, kWarpMaxCand < C <= kBlockMaxCand = 32768 (k 100 x
// degree 8, the depth first-stage retrieval hands a re-ranker, is 800):
// one block of the same kWarps warps per query, the ids in dynamic
// shared memory, padded with INT_MAX to P, the next power of two (at
// least 1024). Its chain of dependent steps is kept short:
// * each warp expands its own chunk of P / kWarps ids, and one bitonic
//   network sorts them in which only the strides of a chunk or more,
//   which pair two warps' ids, wait at a block barrier: shorter strides
//   run in registers and shuffles (below kSegKeys) or on the warp's own
//   chunk behind __syncwarp (block_sort, in block_sort.cuh, which
//   block_cand.cu shares: 14 barriers for the 55 steps at P 1,024);
// * duplicates (an id equal to its left neighbour) and seen ids are
//   marked in a bitmap of P bits beside them: each seen id is searched
//   (lower bound) in the sorted ids, all of them at once over the
//   block's threads, so the seen row is read once, coalesced (its first
//   kThreads ids in flight from the kernel's start), and never broadcast
//   id by id (at C 800 and a seen row of thousands that broadcast would
//   be the chain);
// * a scan compacts (compact_by_scan, in block_sort.cuh beside the
//   duplicate marks): the unmarked ids below n_docs move, in order, to
//   the front (a ballot a warp, the warps' counts scanned across the
//   block, kThreads positions a round), n_docs fills the rest, and the
//   scan's total is the live count;
// * the rescoring is the warp route's, the same code (for u8 values
//   kBlockQuantRows rows a warp at once: a row sums alike whatever the
//   rows); at k 100 and 256 queries it takes most of a block's cycles
//   (scripts/kernel_variants.py's clock64 probe);
// * kBlockRouteBlocksPerSm blocks fit an SM (the launch bound holds the
//   registers to 64 a thread), so 264 queries run in one wave.
// Shared memory is 4 P + P / 8 + 16 bytes (refine_block_smem: the ids,
// the bitmap, 16 spare bytes) and 128 static bytes of the scan's warp
// counts: 135,312 at the cap, within a block's 232,448; at the next power
// of two it would not fit. The seen row never lives in shared memory, so
// W does not bound C.
//
// The q lookups go to L2 (QRow): at the smoke's shapes a query's 34.5
// live rows x 128 lookups touch 38.5 KB of distinct 32-byte sectors of
// q_dense (chip_smoke.py phase 8), where a query bitmap would be built
// from the whole 119 KB row (d = 30522). Each row is summed by
// row_dot.cuh's row_dots in its one order, as gather_dot_cand sums it:
// fuse levels 0, 1 and 2, and both routes, rescore a document bitwise
// alike. No launch allocates; each runs on the caller's stream and its C
// entry point returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "block_sort.cuh"
#include "row_dot.cuh"

namespace {

constexpr int kWarps = 16;             // warps per block (one query)
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;               // candidate rows a warp scores at once
constexpr int kAhead = 4;              // entries per lane and row ahead
constexpr int kSeenAhead = 4;          // 32-id chunks of the seen row loaded
                                       // at the start
constexpr int kWarpMaxCand = 512;      // the warp route: 16 ids a lane
constexpr int kBlockMinKeys = 1024;    // the block route's smallest sort
constexpr int kBlockMaxCand = 32768;   // the block route's cap
constexpr int kSmemMax = 232448;       // a block's dynamic shared memory
constexpr int kBlockRouteBlocksPerSm = 2;   // the block route's launch bound
constexpr int kBlockQuantRows = 3;     // rows a warp rescores at once on the
                                       // block route for u8 values: 4 spill
                                       // under its launch bound
static_assert(kBlockMinKeys / kWarps >= seismic::kSegKeys,
              "a warp's chunk of the smallest sort holds a segment");

// Dynamic shared memory of the block route for P sort keys: the keys, a
// bitmap of P bits, 16 spare bytes.
constexpr int block_smem_bytes(int keys) { return keys * 4 + keys / 8 + 16; }
static_assert(block_smem_bytes(kBlockMaxCand) + 2 * kWarps * 4 <= kSmemMax,
              "the block route's cap and its scan's warp counts must fit a "
              "block's shared memory");
static_assert(block_smem_bytes(2 * kBlockMaxCand) > kSmemMax,
              "the cap is the most keys (a power of two) that fit");

using seismic::QRow;
using seismic::block_sort;
using seismic::compact_by_scan;
using seismic::kSegKeys;
using seismic::mark_duplicates;
using seismic::row_dots;

// Ascending bitonic sort of the warp's 32 * KPL keys, lane l holding keys
// l * KPL .. l * KPL + KPL - 1: exchanges within a lane swap registers,
// exchanges across lanes trade through __shfl_xor_sync.
template <int KPL>
__device__ __forceinline__ void warp_sort(int (&key)[KPL], int lane) {
  constexpr int P = 32 * KPL;
#pragma unroll
  for (int k = 2; k <= P; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= KPL) {
#pragma unroll
        for (int e = 0; e < KPL; ++e) {
          const int i = lane * KPL + e;
          const int other = __shfl_xor_sync(0xffffffffu, key[e], j / KPL);
          const bool lower = (i & j) == 0, up = (i & k) == 0;
          key[e] = lower == up ? min(key[e], other) : max(key[e], other);
        }
      } else {
#pragma unroll
        for (int e = 0; e < KPL; ++e) {
          const int f = e ^ j;
          if (f > e) {
            const int a = key[e], b = key[f];
            if ((a > b) == (((lane * KPL + e) & k) == 0)) {
              key[e] = b;
              key[f] = a;
            }
          }
        }
      }
    }
  }
}

// Writes a query's frontier front[0, n_cand) to cand and rescores its
// live prefix front[0, nl) into out (-inf past it): the block's warps
// split the prefix, R rows a warp at once, every row summed by row_dots
// in its one order (whatever R).
template <int R, typename C, typename V, bool kQuant>
__device__ __forceinline__ void rescore(
    const int* front, int nl, int n_cand, long long qi,
    const float* __restrict__ q, const C* __restrict__ fwd_coords,
    const V* __restrict__ fwd_vals, const float* __restrict__ fwd_scale,
    const float* __restrict__ fwd_zero, int32_t* __restrict__ cand,
    float* __restrict__ out, int nnz, int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = qi * n_cand;
  for (int t = threadIdx.x; t < n_cand; t += kThreads) {
    cand[base + t] = front[t];
    if (t >= nl) out[base + t] = -INFINITY;
  }
  const QRow qv{q + qi * d};
  for (int i0 = warp * R; i0 < nl; i0 += kWarps * R) {
    const C* c[R];
    const V* v[R];
    float sc[R], z[R], r[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int fid = front[i0 + j < nl ? i0 + j : i0];
      const long long doc = fid < 0 ? 0 : fid;
      c[j] = fwd_coords + doc * nnz;
      v[j] = fwd_vals + doc * nnz;
      sc[j] = z[j] = 0.0f;
      if constexpr (kQuant) {
        sc[j] = fwd_scale[doc];
        z[j] = fwd_zero[doc];
      }
    }
    row_dots<R, kAhead, C, V, kQuant>(qv, c, v, nnz, sc, z, lane, r);
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (lane == j && i0 + j < nl) out[base + i0 + j] = r[j];
  }
}

template <int KPL, typename C, typename V, bool kQuant>
__global__ void __launch_bounds__(kThreads)
refine_round_kernel(const int32_t* __restrict__ ids,
                    const int32_t* __restrict__ scored,
                    const float* __restrict__ q,
                    const int32_t* __restrict__ knn,
                    const C* __restrict__ fwd_coords,
                    const V* __restrict__ fwd_vals,
                    const float* __restrict__ fwd_scale,
                    const float* __restrict__ fwd_zero,
                    int32_t* __restrict__ cand, float* __restrict__ out,
                    int k, int W, int degree, int knn_deg, int n_docs,
                    int nnz, int d) {
  __shared__ int front[32 * KPL];     // the compacted frontier
  __shared__ int n_live;
  const long long qi = blockIdx.x;
  const int n_cand = k * degree;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    // the first chunks of the seen row, in flight during the expansion
    const int32_t* seen = scored + qi * W;
    int sv[kSeenAhead];
#pragma unroll
    for (int c = 0; c < kSeenAhead; ++c)
      sv[c] = c * 32 + lane < W ? seen[c * 32 + lane] : n_docs;
    // ---- 1. expand: this lane's ids l * KPL + e, then their neighbours
    int key[KPL], id[KPL];
#pragma unroll
    for (int e = 0; e < KPL; ++e) {
      const int t = lane * KPL + e;
      id[e] = t < n_cand ? ids[qi * k + t / degree] : 0;
    }
#pragma unroll
    for (int e = 0; e < KPL; ++e) {
      const int t = lane * KPL + e;
      key[e] = INT_MAX;
      if (t < n_cand)
        key[e] = id[e] < 0
                     ? n_docs
                     : knn[(long long)min(id[e], n_docs - 1) * knn_deg +
                           t % degree];
    }
    warp_sort<KPL>(key, lane);
    // ---- 2. dedupe against the left neighbour, 3. the seen set
    const int left = __shfl_up_sync(0xffffffffu, key[KPL - 1], 1);
    int m[KPL];
#pragma unroll
    for (int e = 0; e < KPL; ++e) {
      const int t = lane * KPL + e;
      const int prev = e ? key[e - 1] : left;
      m[e] = t > 0 && t < n_cand && key[e] == prev ? n_docs : key[e];
    }
    auto mask_seen = [&](int v) {
#pragma unroll
      for (int e = 0; e < KPL; ++e)
        if (lane * KPL + e < n_cand && m[e] == v) m[e] = n_docs;
    };
    for (int c0 = 0; c0 < W; c0 += 32) {
      const int c = c0 / 32;
      int x = n_docs;
      if (c < kSeenAhead) {
#pragma unroll
        for (int a = 0; a < kSeenAhead; ++a)
          if (a == c) x = sv[a];
      } else if (c0 + lane < W) {
        x = seen[c0 + lane];
      }
      const int n_here = min(32, W - c0);
#pragma unroll 8
      for (int s = 0; s < n_here; ++s)
        mask_seen(__shfl_sync(0xffffffffu, x, s));
    }
    // ---- 4. compact: live ids to a sorted prefix
    warp_sort<KPL>(m, lane);
    int live = 0;
#pragma unroll
    for (int e = 0; e < KPL; ++e) {
      front[lane * KPL + e] = m[e];
      live += lane * KPL + e < n_cand && m[e] < n_docs;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      live += __shfl_xor_sync(0xffffffffu, live, o);
    if (lane == 0) n_live = live;
  }
  __syncthreads();
  // ---- 5. write the frontier; rescore its live prefix
  rescore<kRows, C, V, kQuant>(front, n_live, n_cand, qi, q, fwd_coords,
                               fwd_vals, fwd_scale, fwd_zero, cand, out, nnz,
                               d);
}

// The block route: C ids a query in dynamic shared memory (see the
// header), the same steps and the same rescoring.

// The first position in key[0, n) (ascending) whose id is not below v.
__device__ __forceinline__ int first_at_least(const int* key, int n, int v) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (key[lo + half] < v) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

template <typename C, typename V, bool kQuant>
__global__ void __launch_bounds__(kThreads, kBlockRouteBlocksPerSm)
refine_block_kernel(const int32_t* __restrict__ ids,
                    const int32_t* __restrict__ scored,
                    const float* __restrict__ q,
                    const int32_t* __restrict__ knn,
                    const C* __restrict__ fwd_coords,
                    const V* __restrict__ fwd_vals,
                    const float* __restrict__ fwd_scale,
                    const float* __restrict__ fwd_zero,
                    int32_t* __restrict__ cand, float* __restrict__ out,
                    int k, int W, int degree, int knn_deg, int n_docs,
                    int nnz, int d, int P) {
  extern __shared__ int smem[];
  int* key = smem;                                     // [P]
  uint32_t* marked = reinterpret_cast<uint32_t*>(smem + P);   // [P / 32]
  const long long qi = blockIdx.x;
  const int n_cand = k * degree;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = P / kWarps, base = warp * chunk;
  // the seen row's first ids, in flight during the expansion and the sort
  const int32_t* seen = scored + qi * W;
  const int seen0 = threadIdx.x < W ? seen[threadIdx.x] : 0;
  // ---- 1. expand, each warp into its own chunk
#pragma unroll 4
  for (int t = base + lane; t < base + chunk; t += 32) {
    int v = INT_MAX;
    if (t < n_cand) {
      const int id = ids[qi * k + t / degree];
      v = id < 0 ? n_docs
                 : knn[(long long)min(id, n_docs - 1) * knn_deg + t % degree];
    }
    key[t] = v;
  }
  for (int w = threadIdx.x; w < P / 32; w += kThreads) marked[w] = 0u;
  __syncwarp();
  block_sort<kWarps>(key, P);
  __syncthreads();
  // ---- 2. duplicates (an id equal to its left neighbour), 3. the seen
  // set: a bit each in marked
  mark_duplicates<kWarps>(key, n_cand, marked);
  for (int s = threadIdx.x; s < W; s += kThreads) {
    const int v = s == threadIdx.x ? seen0 : seen[s];
    const int pos = first_at_least(key, n_cand, v);
    if (pos < n_cand && key[pos] == v)
      atomicOr(&marked[pos >> 5], 1u << (pos & 31));
  }
  __syncthreads();
  // ---- 4. compact by a scan (block_sort.cuh): the live ids (unmarked,
  // below n_docs) move to the front in order. No key in [0, C) exceeds
  // n_docs (knn rows hold ids below n_docs and the sentinel n_docs, which
  // pads them; a -1 top-k id expands to n_docs), so what the plain
  // version's second sort leaves, the live ids in order and then n_docs
  // only, is this stable partition; its count replaces the lower bound
  // of n_docs.
  const int nl = compact_by_scan<kWarps>(key, marked, n_cand, n_docs);
  for (int t = nl + threadIdx.x; t < n_cand; t += kThreads) key[t] = n_docs;
  __syncthreads();
  // ---- 5. write the frontier; rescore its live prefix
  rescore<kQuant ? kBlockQuantRows : kRows, C, V, kQuant>(
      key, nl, n_cand, qi, q, fwd_coords, fwd_vals, fwd_scale, fwd_zero, cand,
      out, nnz, d);
}

// ids a lane of the sorting warp holds for C candidates: 4 (C <= 128) or
// 16 (C <= kWarpMaxCand); 0 where the warp route does not take C
int keys_per_lane(int n_cand) {
  return n_cand <= 128 ? 4 : (n_cand <= kWarpMaxCand ? 16 : 0);
}

// The block route's sort keys for C candidates: the next power of two,
// at least kBlockMinKeys
int block_keys(int n_cand) {
  int p = kBlockMinKeys;
  while (p < n_cand) p <<= 1;
  return p;
}

template <typename C, typename V, bool kQuant>
int launch(const int32_t* ids, const int32_t* scored, const float* q,
           const int32_t* knn, const void* fwd_coords, const void* fwd_vals,
           const float* fwd_scale, const float* fwd_zero, int32_t* cand,
           float* out, int Q, int k, int W, int degree, int knn_deg,
           int n_docs, int nnz, int d, cudaStream_t stream) {
  const int n_cand = k * degree;
  if (n_cand > kWarpMaxCand) {
    const int P = block_keys(n_cand);
    const int smem = block_smem_bytes(P);
    auto kernel = refine_block_kernel<C, V, kQuant>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)Q, kThreads, smem, stream>>>(
        ids, scored, q, knn, static_cast<const C*>(fwd_coords),
        static_cast<const V*>(fwd_vals), fwd_scale, fwd_zero, cand, out, k,
        W, degree, knn_deg, n_docs, nnz, d, P);
    return (int)cudaGetLastError();
  }
  const int kpl = keys_per_lane(n_cand);
  auto kernel = kpl == 4 ? refine_round_kernel<4, C, V, kQuant>
                         : refine_round_kernel<16, C, V, kQuant>;
  kernel<<<(unsigned)Q, kThreads, 0, stream>>>(
      ids, scored, q, knn, static_cast<const C*>(fwd_coords),
      static_cast<const V*>(fwd_vals), fwd_scale, fwd_zero, cand, out, k, W,
      degree, knn_deg, n_docs, nnz, d);
  return (int)cudaGetLastError();
}

// Does nothing: its launch time is the floor under a kernel as short as
// this one (chip_smoke.py prints it beside refine_round's time).
__global__ void empty_kernel() {}

}  // namespace

extern "C" int refine_empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}

// The most candidates (k * degree) a launch takes, and the most the warp
// route takes (more go to the block route).
extern "C" int refine_max_candidates() { return kBlockMaxCand; }
extern "C" int refine_warp_max_candidates() { return kWarpMaxCand; }

// The block route's dynamic shared memory for C candidates (bytes); -1
// for a C the block route does not take.
extern "C" int refine_block_smem(int n_cand) {
  if (n_cand <= kWarpMaxCand || n_cand > kBlockMaxCand) return -1;
  return block_smem_bytes(block_keys(n_cand));
}

// coord_kind: 0 = int32, 1 = uint16.
// val_kind:   0 = float32, 1 = bfloat16, 2 = uint8 with per-row dequant.
extern "C" int refine_round_launch(
    const int32_t* ids, const int32_t* scored, const float* q,
    const int32_t* knn, const void* fwd_coords, const void* fwd_vals,
    const float* fwd_scale, const float* fwd_zero, int32_t* cand, float* out,
    int Q, int k, int W, int degree, int knn_deg, int n_docs, int nnz, int d,
    int coord_kind, int val_kind, cudaStream_t stream) {
  if (k < 1 || degree < 1 || degree > knn_deg || n_docs < 1 || W < 0 ||
      (long long)k * degree > kBlockMaxCand)
    return (int)cudaErrorInvalidValue;
#define REFINE_ARGS                                                          \
  ids, scored, q, knn, fwd_coords, fwd_vals, fwd_scale, fwd_zero, cand, out, \
      Q, k, W, degree, knn_deg, n_docs, nnz, d, stream
  if (coord_kind == 0) {
    if (val_kind == 0) return launch<int32_t, float, false>(REFINE_ARGS);
    if (val_kind == 1)
      return launch<int32_t, __nv_bfloat16, false>(REFINE_ARGS);
    if (val_kind == 2) return launch<int32_t, uint8_t, true>(REFINE_ARGS);
  } else if (coord_kind == 1) {
    if (val_kind == 0) return launch<uint16_t, float, false>(REFINE_ARGS);
    if (val_kind == 1)
      return launch<uint16_t, __nv_bfloat16, false>(REFINE_ARGS);
    if (val_kind == 2) return launch<uint16_t, uint8_t, true>(REFINE_ARGS);
  }
#undef REFINE_ARGS
  return (int)cudaErrorInvalidValue;
}
