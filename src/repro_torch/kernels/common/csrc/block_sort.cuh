// block_sort.cuh: one thread block's ids in shared memory sorted, their
// duplicates marked and the rest compacted, for refine_fused.cu's block
// route and block_cand.cu.
//
// * block_sort: an ascending bitonic sort of key[0, P), P a power of two,
//   warp w of kWarps owning the chunk [w P / kWarps, (w + 1) P / kWarps)
//   of at least kSegKeys keys. Only the strides of a chunk or more, which
//   pair two warps' keys, wait at a block barrier: strides below kSegKeys
//   run in registers and shuffles, strides from kSegKeys up to the chunk
//   on the warp's own chunk behind __syncwarp (at P 1,024 and 16 warps 10
//   of the 55 steps, 14 barriers).
// * mark_duplicates: a bit in a bitmap beside the keys for each sorted id
//   equal to its left neighbour (a ballot a warp).
// * compact_by_scan: the unmarked ids below n_docs move, in order, to the
//   front (a ballot a warp, the warps' counts scanned across the block,
//   kWarps * 32 positions a round); it returns the live count. An id never
//   moves right, so a round writes only positions the block has read.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace seismic {

constexpr int kSegKeys = 64;           // keys a warp sorts in registers,
                                       // 2 a lane

// One compare-exchange of the bitonic network on key[lo] < key[hi] in
// position, ascending where up.
__device__ __forceinline__ void bitonic_exchange(int* key, int lo, int hi,
                                                 bool up) {
  const int a = key[lo], b = key[hi];
  if ((a > b) == up) {
    key[lo] = b;
    key[hi] = a;
  }
}

// The steps j = jtop, jtop / 2, ..., 1 of merge size kk on a warp's
// segment of kSegKeys keys in registers, lane l holding positions pos and
// pos + 1 (pos = the segment's start + 2 l): stride 1 swaps a lane's two
// registers, strides 2..32 trade through __shfl_xor_sync; no barrier.
__device__ __forceinline__ void segment_steps(int (&v)[2], int pos, int kk,
                                              int jtop) {
  const bool up = (pos & kk) == 0;       // pos is even: pos + 1 alike
  for (int j = jtop; j > 1; j >>= 1) {
    const bool keep_min = ((pos & j) == 0) == up;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int other = __shfl_xor_sync(0xffffffffu, v[e], j >> 1);
      v[e] = keep_min ? min(v[e], other) : max(v[e], other);
    }
  }
  if ((v[0] > v[1]) == up) {
    const int a = v[0];
    v[0] = v[1];
    v[1] = a;
  }
}

// Runs merge size kk's steps below kSegKeys (jtop = kSegKeys / 2) on each
// kSegKeys-key segment of the warp's chunk [base, base + chunk), or, with
// kk 0, every merge up to kSegKeys (each segment sorted, alternately up
// and down as its position says).
__device__ __forceinline__ void segment_run(int* key, int base, int chunk,
                                            int kk, int lane) {
  for (int s = base + 2 * lane; s < base + chunk; s += kSegKeys) {
    const int2 two = *reinterpret_cast<const int2*>(key + s);
    int v[2] = {two.x, two.y};
    if (kk)
      segment_steps(v, s, kk, kSegKeys / 2);
    else
      for (int m = 2; m <= kSegKeys; m <<= 1) segment_steps(v, s, m, m >> 1);
    *reinterpret_cast<int2*>(key + s) = make_int2(v[0], v[1]);
  }
}

// Ascending bitonic sort of key[0, P) by a block of kWarps warps (see the
// header). Each warp starts on its own chunk, so a warp that wrote only
// its chunk needs no block barrier before; the caller syncs the block
// before it reads what other warps sorted.
template <int kWarps>
__device__ __forceinline__ void block_sort(int* key, int P) {
  constexpr int kThreads = kWarps * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = P / kWarps, base = warp * chunk;
  segment_run(key, base, chunk, 0, lane);
  for (int kk = 2 * kSegKeys; kk <= P; kk <<= 1) {
    int j = kk >> 1;
    if (j >= chunk) {
      for (; j >= chunk; j >>= 1) {
        __syncthreads();
        for (int i = threadIdx.x; i < P / 2; i += kThreads) {
          const int lo = 2 * i - (i & (j - 1));
          bitonic_exchange(key, lo, lo + j, (lo & kk) == 0);
        }
      }
      __syncthreads();
    }
    for (; j >= kSegKeys; j >>= 1) {
      __syncwarp();
      for (int i = lane; i < chunk / 2; i += 32) {
        const int lo = base + 2 * i - (i & (j - 1));
        bitonic_exchange(key, lo, lo + j, (lo & kk) == 0);
      }
    }
    __syncwarp();
    segment_run(key, base, chunk, kk, lane);
  }
}

// Sets the bit of each position t in [1, n_cand) of the sorted key whose
// id equals its left neighbour's in marked (zeroed by the caller; other
// marks may share it).
template <int kWarps>
__device__ __forceinline__ void mark_duplicates(const int* key, int n_cand,
                                                uint32_t* marked) {
  constexpr int kThreads = kWarps * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t0 = warp * 32; t0 < n_cand; t0 += kThreads) {
    const int t = t0 + lane;
    const unsigned dup = __ballot_sync(
        0xffffffffu, t > 0 && t < n_cand && key[t] == key[t - 1]);
    if (lane == 0 && dup) atomicOr(&marked[t0 >> 5], dup);
  }
}

// Compacts key[0, n_cand) by a scan: the live ids (unmarked, below n_docs)
// move to the front in order, rounds of kWarps * 32 positions, each id to
// the live count before it (a ballot within the warp, the warps' counts
// scanned across the block). Returns the live count, the same in every
// thread; what lies past it is left as it was. The caller syncs the block
// before (the marks) and after (the moved ids).
template <int kWarps>
__device__ __forceinline__ int compact_by_scan(int* key,
                                               const uint32_t* marked,
                                               int n_cand, int n_docs) {
  constexpr int kThreads = kWarps * 32;
  static_assert(kWarps <= 32, "the warps' counts are scanned in one warp");
  __shared__ int warp_live[2][kWarps];   // the scan's warp counts, by round
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int nl = 0;
  for (int t0 = 0, r = 0; t0 < n_cand; t0 += kThreads, r ^= 1) {
    const int t = t0 + threadIdx.x;
    const int v = t < n_cand ? key[t] : n_docs;
    const bool live = t < n_cand && v < n_docs &&
                      !((marked[t >> 5] >> (t & 31)) & 1u);
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_live[r][warp] = __popc(ballot);
    __syncthreads();
    const int c = lane < kWarps ? warp_live[r][lane] : 0;
    int upto = c;                              // the warps' inclusive scan
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, upto, o);
      if (lane >= o) upto += x;
    }
    const int before = __shfl_sync(0xffffffffu, upto - c, warp);
    if (live) key[nl + before + __popc(ballot & ((1u << lane) - 1u))] = v;
    nl += __shfl_sync(0xffffffffu, upto, kWarps - 1);
  }
  return nl;
}

}  // namespace seismic
