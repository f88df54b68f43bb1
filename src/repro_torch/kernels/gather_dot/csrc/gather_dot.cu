// gather_dot.cu: the scorer's exact sparse-dense dots, for Hopper (sm_90a).
//
// Replaces two TPU kernels of src/repro/kernels/gather_dot/gather_dot.py:
//
// * gather_dot_batch_pallas (_gather_dot_kernel, _gather_dot_quant_kernel):
//     s[q, n] = sum_j q_dense[q, coords[q, n, j]] * v[q, n, j]
//   over rows the caller gathered, v in f32 or bf16, or u8 dequantized per
//   row as (u - 1) * scale[q, n] + zero[q, n] with level 0 -> 0;
// * gather_dot_cand_pallas (_gather_dot_cand_kernel and its quant twin):
//   the same dot for candidate doc ids cand[q, c], gathering each
//   candidate's row of the forward plane [n_docs, nnz] itself. An id
//   >= n_docs (the sentinel) scores -inf; a tile of candidates that are all
//   sentinels is skipped whole (no row is gathered).
// Coordinates are i32, or u16 on a compact forward index (widened here).
//
// Bound on an H100: bytes. An entry is 6 bytes (i32 coord + bf16 value)
// for 2 flops. Scorer shapes (Q = 256, N = 4096, nnz = 128, bf16): 134.2 M
// entries, about 0.84 GB with q: at least 0.25 ms at 3.35 TB/s; the
// adaptive selector's stage 1 (N = 512) about 0.04 ms. The candidate
// kernel moves what its live candidates need: one 128 x 6 B row per
// distinct live document (a document that several queries share is read
// once), plus the ids, q and the output.
//
// Design. The batch kernel: one warp per output element, lanes striding
// nnz (coalesced coords and values), q gathered through __ldg from L2
// (q_dense is 31 MB at Q = 256), a warp-shuffle tree, lane 0 stores.
// The candidate kernel is latency-bound if each warp walks its rows one
// after another (id, then the row, then q at the row's coordinates in
// L2, then the shuffles, then the next row: 24 % of the byte bound). Its
// block is one tile of tile_n candidates of one query (ops.CAND_TILE_N =
// 768), the blocks ordered tile index first: the 256 threads read the
// tile's ids into shared memory at once, __syncthreads_or over them is
// the skip predicate that cand_tiles_processed (ops.py) mirrors, and the
// block then marks the query's non-zeros in a shared-memory bitmap (one
// coalesced pass over q_dense's row; d / 8 bytes), so that a coordinate
// the query lacks (89 % of the lookups at the MS MARCO shapes) costs no
// L2 sector: it contributes q_dense's own +0.0. Each warp scores R = 2
// candidates at once, their coords and values loaded 4 entries per lane
// ahead of the lookups (row_dots). Both kernels use the shared row dot
// of row_dot.cuh, as the fused router and refine kernels do, so for the
// same row they give bitwise the same score: the fused and unfused
// scorer and refine paths agree exactly. No launch allocates; each runs
// on the caller's stream and its C entry point returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_dot.cuh"

namespace {

constexpr int kWarps = 8;       // warps per 256-thread block
constexpr int kCandMaxTile = 1024;    // candidate ids a block holds
constexpr int kCandRows = 2;          // candidate rows per warp at once
constexpr int kCandBatch = 4;         // entries per lane and row per batch

using seismic::QMasked;
using seismic::row_dot;
using seismic::row_dots;

template <typename C, typename V, bool kQuant>
__global__ void __launch_bounds__(kWarps * 32)
gather_dot_batch_kernel(const float* __restrict__ q,
                        const C* __restrict__ coords,
                        const V* __restrict__ vals,
                        const float* __restrict__ scale,
                        const float* __restrict__ zero,
                        float* __restrict__ out, long long rows, int N,
                        int nnz, int d) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float sc = 0.0f, z = 0.0f;
  if constexpr (kQuant) {
    sc = scale[row];
    z = zero[row];
  }
  const float r = row_dot<C, V, kQuant>(q + (row / N) * (long long)d,
                                        coords + row * nnz, vals + row * nnz,
                                        nnz, sc, z, lane);
  if (lane == 0) out[row] = r;
}

template <typename C, typename V, bool kQuant>
__global__ void __launch_bounds__(kWarps * 32)
gather_dot_cand_kernel(const float* __restrict__ q,
                       const int32_t* __restrict__ cand,
                       const C* __restrict__ fwd_coords,
                       const V* __restrict__ fwd_vals,
                       const float* __restrict__ fwd_scale,
                       const float* __restrict__ fwd_zero,
                       float* __restrict__ out, int n_cand, int tile_n,
                       int tiles_per_row, int n_docs, int nnz, int d) {
  __shared__ int ids[kCandMaxTile];
  extern __shared__ uint32_t bits[];      // ceil(d / 32) words
  // tile index major: the blocks that run together hold one tile of
  // many queries, whose sorted ids span similar documents
  const int n_q = gridDim.x / tiles_per_row;
  const int qi = blockIdx.x % n_q;
  const int n0 = (blockIdx.x / n_q) * tile_n;
  const long long base = (long long)qi * n_cand;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tile = min(tile_n, n_cand - n0);
  int any = 0;
  for (int i = t; i < tile_n; i += kWarps * 32) {
    const int id = i < tile ? cand[base + n0 + i] : n_docs;
    ids[i] = id;
    any |= id < n_docs;
  }
  if (!__syncthreads_or(any)) {           // all-sentinel tile: skip
    for (int i = t; i < tile; i += kWarps * 32) out[base + n0 + i] = -INFINITY;
    return;
  }
  const float* qrow = q + (long long)qi * d;
  // q_row's non-zeros, U words per warp at once: the words row_dot.cuh's
  // mark_nonzeros makes, written out because through that helper the f32
  // and bf16 variants compile to more than 48 registers and lose
  // occupancy
  constexpr int U = 16;
  for (int w0 = warp * U; w0 * 32 < d; w0 += kWarps * U) {
    float x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = (w0 + u) * 32 + lane;
      x[u] = c < d ? __ldg(qrow + c) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint32_t m =
          __ballot_sync(0xffffffffu, __float_as_uint(x[u]) != 0u);
      if (lane == 0 && (w0 + u) * 32 < d) bits[w0 + u] = m;
    }
  }
  __syncthreads();
  // warp w scores candidates w R .. w R + R - 1 of each kWarps R (a
  // group) together, a sentinel's score -inf; a group with no live
  // candidate reads nothing
  constexpr int R = kCandRows;
  const int first = warp * R, step = kWarps * R;
  const int n_groups = first < tile ? (tile - first + step - 1) / step : 0;
  float sc[R], z[R], r[R];
  for (int g = 0; g < n_groups; ++g) {
    const int k0 = first + g * step;
    const C* c[R];
    const V* v[R];
    bool alive[R], live_any = false;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int id = k0 + i < tile ? ids[k0 + i] : n_docs;
      alive[i] = id < n_docs;
      live_any |= alive[i];
      const long long doc = alive[i] && id > 0 ? id : 0;
      c[i] = fwd_coords + doc * nnz;
      v[i] = fwd_vals + doc * nnz;
      sc[i] = z[i] = 0.0f;
      if constexpr (kQuant) {
        sc[i] = fwd_scale[doc];
        z[i] = fwd_zero[doc];
      }
    }
    if (live_any)
      row_dots<R, kCandBatch, C, V, kQuant>(QMasked{qrow, bits}, c, v, nnz,
                                            sc, z, lane, r);
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (lane == i && k0 + i < tile)
        out[base + n0 + k0 + i] = alive[i] ? r[i] : -INFINITY;
  }
}

template <typename C, typename V, bool kQuant>
int launch_batch(const float* q, const void* coords, const void* vals,
                 const float* scale, const float* zero, float* out, int Q,
                 int N, int nnz, int d, cudaStream_t stream) {
  const long long rows = (long long)Q * N;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  gather_dot_batch_kernel<C, V, kQuant><<<(unsigned)blocks, kWarps * 32, 0,
                                          stream>>>(
      q, static_cast<const C*>(coords), static_cast<const V*>(vals), scale,
      zero, out, rows, N, nnz, d);
  return (int)cudaGetLastError();
}

template <typename C, typename V, bool kQuant>
int launch_cand(const float* q, const int32_t* cand, const void* fwd_coords,
                const void* fwd_vals, const float* fwd_scale,
                const float* fwd_zero, float* out, int Q, int n_cand,
                int tile_n, int n_docs, int nnz, int d, cudaStream_t stream) {
  const int tiles = (n_cand + tile_n - 1) / tile_n;
  const long long blocks = (long long)Q * tiles;
  const int smem = (d + 31) / 32 * 4;     // the q bitmap
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_dot_cand_kernel<C, V, kQuant>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  gather_dot_cand_kernel<C, V, kQuant><<<(unsigned)blocks, kWarps * 32,
                                         smem, stream>>>(
      q, cand, static_cast<const C*>(fwd_coords),
      static_cast<const V*>(fwd_vals), fwd_scale, fwd_zero, out, n_cand,
      tile_n, tiles, n_docs, nnz, d);
  return (int)cudaGetLastError();
}

}  // namespace

// coord_kind: 0 = int32, 1 = uint16.
// val_kind:   0 = float32, 1 = bfloat16, 2 = uint8 with per-row dequant.
#define GATHER_DOT_DISPATCH(LAUNCH, ...)                                     \
  if (coord_kind == 0) {                                                     \
    if (val_kind == 0) return LAUNCH<int32_t, float, false>(__VA_ARGS__);    \
    if (val_kind == 1)                                                       \
      return LAUNCH<int32_t, __nv_bfloat16, false>(__VA_ARGS__);             \
    if (val_kind == 2) return LAUNCH<int32_t, uint8_t, true>(__VA_ARGS__);   \
  } else if (coord_kind == 1) {                                              \
    if (val_kind == 0) return LAUNCH<uint16_t, float, false>(__VA_ARGS__);   \
    if (val_kind == 1)                                                       \
      return LAUNCH<uint16_t, __nv_bfloat16, false>(__VA_ARGS__);            \
    if (val_kind == 2) return LAUNCH<uint16_t, uint8_t, true>(__VA_ARGS__);  \
  }                                                                          \
  return (int)cudaErrorInvalidValue;

extern "C" int gather_dot_batch_launch(const float* q, const void* coords,
                                       const void* vals, const float* scale,
                                       const float* zero, float* out, int Q,
                                       int N, int nnz, int d, int coord_kind,
                                       int val_kind, cudaStream_t stream) {
  GATHER_DOT_DISPATCH(launch_batch, q, coords, vals, scale, zero, out, Q, N,
                      nnz, d, stream)
}

extern "C" int gather_dot_cand_launch(const float* q, const int32_t* cand,
                                      const void* fwd_coords,
                                      const void* fwd_vals,
                                      const float* fwd_scale,
                                      const float* fwd_zero, float* out,
                                      int Q, int n_cand, int tile_n,
                                      int n_docs, int nnz, int d,
                                      int coord_kind, int val_kind,
                                      cudaStream_t stream) {
  // tile_n in [1, kCandMaxTile]: the block holds the tile's ids
  if (tile_n < 1 || tile_n > kCandMaxTile) return (int)cudaErrorInvalidValue;
  GATHER_DOT_DISPATCH(launch_cand, q, cand, fwd_coords, fwd_vals, fwd_scale,
                      fwd_zero, out, Q, n_cand, tile_n, n_docs, nnz, d,
                      stream)
}
