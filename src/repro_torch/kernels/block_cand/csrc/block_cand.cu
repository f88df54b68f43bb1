// block_cand.cu: the scorer's candidates, the doc ids of each query's
// selected blocks, for Hopper (sm_90a).
//
// Replaces the composition of array operations that the JAX package's
// scorer (src/repro/retrieval/scorer.py) runs ahead of the candidate-driven
// scorer at fuse level 1: gather_block_docs, the mask of blocks whose
// selection score is not finite, mask_tombstoned, dedupe_batch and
// compact_candidates. Per query q of B selected blocks it
//
//   1. gathers each selected block's ids: block = blocks[q, b] (a flat id
//      into the router's (cut, n_blocks) scores), its coordinate
//      coord = lists[q, block / n_blocks] and its slot bi = block %
//      n_blocks; off = block_off[coord, bi], len = block_len[coord, bi];
//      ids list_docs[coord, off + j] (the position clipped to [0, lam))
//      for j < len and the sentinel n_docs for len <= j < block_cap; the
//      whole block is the sentinel where block_scores is given and
//      block_scores[q, b] is not finite, and an id is the sentinel where a
//      tombstone plane is given and marks it (read at min(id, n_tomb - 1),
//      as the plain version clips);
//   2. sorts the C = B * block_cap ids;
//   3. marks each id equal to its left neighbour;
//   4. compacts the unmarked ids below n_docs to an ascending prefix by a
//      scan, n_docs filling the rest,
//
// and writes cand [Q, C] int32. The ids are what the plain version's two
// sorts give, bit for bit: no list_docs id within a block's length exceeds
// n_docs (a mutable index's purged members are n_docs), so its second sort
// leaves the live ids in order and then n_docs only, which is this stable
// partition.
//
// Bound on an H100: bytes, and small. It reads blocks' row (8 B a block),
// each block's coordinate, offset and length, and at most block_cap ids of
// 4 B a block, coalesced; it writes C ids of 4 B. At 4,096 queries of 128
// blocks of 64 ids that is 134 MB read and 134 MB written, 0.08 ms at 3.35
// TB/s. What the plain version pays beyond it, a segmented sort of ids
// and int64 positions by a library, twice, and a dozen elementwise passes
// over [Q, B, 64] tensors, is the overhead this kernel takes out; the
// sort here runs in shared memory.
//
// One block of kWarps warps takes one query (warps_for: 4 warps up to
// 1,024 sort keys, 8 at 2,048, 16 beyond), the ids in dynamic shared
// memory padded with n_docs to P, the next power of two of C (at least
// kWarps * kSegKeys). The blocks' coordinates, offsets and lengths are
// read once a block into shared memory (kThreads blocks a round), then
// every thread reads ids, a warp's 32 consecutive slots coalesced. The
// sort, the duplicate marks and the scan are refine_fused.cu's block
// route's (block_sort.cuh): the bitonic sort with block barriers only at
// the strides that pair two warps' ids. An LSD radix sort of the ids, 8
// bits a pass over the bits of n_docs, through a second buffer, took 2.0x
// to 2.4x its time at 4,096 queries of 512 to 8,192 ids on an H100
// (scripts/block_cand_times.py keeps it as a variant): a match of equal
// digits and a scattered write for every id, each pass, against passes
// that pair ids in registers and conflict-free shared memory. Shared
// memory is 4 P + P / 8 + 16 bytes dynamic (smem_bytes) and
// 12 kThreads + 8 kWarps static: 33,808 + 6,272 at C 8,192, so 5 blocks
// fit an SM's 228 KB; the launch bound holds the registers to 2,048
// threads an SM. No launch allocates; each runs on the caller's stream and
// its C entry point returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_sort.cuh"

namespace {

constexpr int kMaxCand = 32768;        // the most ids a query (the cap)
constexpr int kSmemMax = 232448;       // a block's dynamic shared memory
constexpr int kThreadsPerSm = 2048;

using seismic::block_sort;
using seismic::compact_by_scan;
using seismic::kSegKeys;
using seismic::mark_duplicates;

// Dynamic shared memory for P sort keys: the keys, a bitmap of P bits,
// 16 spare bytes (the layout of refine_fused.cu's block route).
constexpr int smem_bytes(int keys) { return keys * 4 + keys / 8 + 16; }
static_assert(smem_bytes(kMaxCand) + 12 * 512 + 8 * 16 <= kSmemMax,
              "the cap's ids, marks and block table must fit a block's "
              "shared memory");

// Warps a block for P sort keys, and the sort keys for C ids: the next
// power of two, at least the warps' segments.
int warps_for(int keys) { return keys <= 1024 ? 4 : (keys <= 2048 ? 8 : 16); }
int sort_keys(int n_cand) {
  int p = 4 * kSegKeys;
  while (p < n_cand) p <<= 1;
  return p;
}

template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32, kThreadsPerSm / (kWarps * 32))
block_cand_kernel(const long long* __restrict__ blocks, int blocks_stride,
                  const float* __restrict__ scores, int scores_stride,
                  const int32_t* __restrict__ lists, int lists_stride,
                  const int32_t* __restrict__ block_off,
                  const int32_t* __restrict__ block_len,
                  const int32_t* __restrict__ list_docs,
                  const uint8_t* __restrict__ tombstone,
                  int32_t* __restrict__ cand, int B, int n_blocks, int cap,
                  int lam, int n_docs, int n_tomb, int P) {
  constexpr int kThreads = kWarps * 32;
  extern __shared__ int smem[];
  int* key = smem;                                            // [P]
  uint32_t* marked = reinterpret_cast<uint32_t*>(smem + P);   // [P / 32]
  // a round's blocks: coordinate, offset, length (0: masked or empty)
  __shared__ int b_coord[kThreads], b_off[kThreads], b_len[kThreads];
  const long long qi = blockIdx.x;
  const int n_cand = B * cap;
  // ---- 1. gather, kThreads blocks a round
  for (int b0 = 0; b0 < B; b0 += kThreads) {
    const int b = b0 + threadIdx.x;
    if (b < B) {
      const long long flat = blocks[qi * blocks_stride + b];
      const int li = (int)(flat / n_blocks), bi = (int)(flat % n_blocks);
      const int coord = lists[qi * lists_stride + li];
      const long long at = (long long)coord * n_blocks + bi;
      const bool on = scores == nullptr ||
                      isfinite(scores[qi * scores_stride + b]);
      b_coord[threadIdx.x] = coord;
      b_off[threadIdx.x] = block_off[at];
      b_len[threadIdx.x] = on ? block_len[at] : 0;
    }
    __syncthreads();
    const int t_end = min(B, b0 + kThreads) * cap;
#pragma unroll 4
    for (int t = b0 * cap + threadIdx.x; t < t_end; t += kThreads) {
      const int r = t / cap - b0, j = t % cap;
      int v = n_docs;
      if (j < b_len[r]) {
        v = list_docs[(long long)b_coord[r] * lam +
                      max(0, min(b_off[r] + j, lam - 1))];
        if (tombstone != nullptr && tombstone[max(0, min(v, n_tomb - 1))])
          v = n_docs;
      }
      key[t] = v;
    }
    __syncthreads();
  }
  for (int t = n_cand + threadIdx.x; t < P; t += kThreads) key[t] = n_docs;
  for (int w = threadIdx.x; w < P / 32; w += kThreads) marked[w] = 0u;
  __syncthreads();
  // ---- 2. sort, 3. mark duplicates, 4. compact by a scan
  block_sort<kWarps>(key, P);
  __syncthreads();
  mark_duplicates<kWarps>(key, n_cand, marked);
  __syncthreads();
  const int nl = compact_by_scan<kWarps>(key, marked, n_cand, n_docs);
  __syncthreads();
  int32_t* row = cand + qi * n_cand;
  for (int t = threadIdx.x; t < n_cand; t += kThreads)
    row[t] = t < nl ? key[t] : n_docs;
}

template <int kWarps>
int launch(const long long* blocks, int blocks_stride, const float* scores,
           int scores_stride, const int32_t* lists, int lists_stride,
           const int32_t* block_off, const int32_t* block_len,
           const int32_t* list_docs, const uint8_t* tombstone,
           int32_t* cand, int Q, int B, int n_blocks, int cap, int lam,
           int n_docs, int n_tomb, int P, cudaStream_t stream) {
  const int smem = smem_bytes(P);
  auto kernel = block_cand_kernel<kWarps>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)Q, kWarps * 32, smem, stream>>>(
      blocks, blocks_stride, scores, scores_stride, lists, lists_stride,
      block_off, block_len, list_docs, tombstone, cand, B, n_blocks, cap, lam,
      n_docs, n_tomb, P);
  return (int)cudaGetLastError();
}

}  // namespace

// blocks: int64 [Q, B] rows blocks_stride apart; scores: f32 [Q, B] rows
// scores_stride apart, or null (no mask); lists: int32 [Q, cut];
// block_off, block_len: int32 [L, n_blocks]; list_docs: int32 [L, lam];
// tombstone: bool [n_tomb] or null; cand: int32 [Q, B * cap]. Past the
// cap (B * cap > kMaxCand) it returns cudaErrorInvalidValue.
extern "C" int block_cand_launch(
    const long long* blocks, int blocks_stride, const float* scores,
    int scores_stride, const int32_t* lists, int lists_stride,
    const int32_t* block_off, const int32_t* block_len,
    const int32_t* list_docs, const uint8_t* tombstone, int32_t* cand, int Q,
    int B, int n_blocks, int cap, int lam, int n_docs, int n_tomb,
    cudaStream_t stream) {
  if (Q < 1 || B < 1 || cap < 1 || n_blocks < 1 || lam < 1 || n_docs < 1 ||
      (long long)B * cap > kMaxCand || (tombstone != nullptr && n_tomb < 1))
    return (int)cudaErrorInvalidValue;
  const int P = sort_keys(B * cap);
  const int warps = warps_for(P);
#define BLOCK_CAND_ARGS                                                     \
  blocks, blocks_stride, scores, scores_stride, lists, lists_stride,        \
      block_off, block_len, list_docs, tombstone, cand, Q, B, n_blocks, cap, \
      lam, n_docs, n_tomb, P, stream
  if (warps == 4) return launch<4>(BLOCK_CAND_ARGS);
  if (warps == 8) return launch<8>(BLOCK_CAND_ARGS);
  return launch<16>(BLOCK_CAND_ARGS);
#undef BLOCK_CAND_ARGS
}
