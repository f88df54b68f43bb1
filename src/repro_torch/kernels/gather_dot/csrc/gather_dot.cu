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
// Design, simple and right first: one warp per output element, lanes
// striding nnz (coalesced coords and values), q gathered through __ldg from
// L2 (q_dense is 31 MB at Q = 256), a warp-shuffle tree, lane 0 stores.
// Both kernels use the shared row dot of row_dot.cuh, as the fused refine
// kernel does, so for the same row they give bitwise the same score: the
// fused and unfused scorer and refine paths agree exactly.
// The candidate kernel's block is one tile of tile_n candidates of one
// query (tile_n = ops.CAND_TILE_N = 32: 8 warps, 4 candidates each);
// __syncthreads_or over the tile's ids is the skip predicate that
// cand_tiles_processed (ops.py) mirrors. No launch allocates; each runs on
// the caller's stream and its C entry point returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_dot.cuh"

namespace {

constexpr int kWarps = 8;       // warps per 256-thread block

using seismic::row_dot;

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
  const int qi = blockIdx.x / tiles_per_row;
  const int n0 = (blockIdx.x % tiles_per_row) * tile_n;
  const long long base = (long long)qi * n_cand;
  const int t = threadIdx.x;
  const bool mine = t < tile_n && n0 + t < n_cand;
  const int live = mine && cand[base + n0 + t] < n_docs;
  if (!__syncthreads_or(live)) {         // all-sentinel tile: skip
    if (mine) out[base + n0 + t] = -INFINITY;
    return;
  }
  const int lane = t & 31;
  const float* qrow = q + (long long)qi * d;
  for (int k = t >> 5; k < tile_n && n0 + k < n_cand; k += kWarps) {
    const int id = cand[base + n0 + k];
    float r = -INFINITY;
    if (id < n_docs) {
      const long long doc = id < 0 ? 0 : id;
      float sc = 0.0f, z = 0.0f;
      if constexpr (kQuant) {
        sc = fwd_scale[doc];
        z = fwd_zero[doc];
      }
      r = row_dot<C, V, kQuant>(qrow, fwd_coords + doc * nnz,
                                fwd_vals + doc * nnz, nnz, sc, z, lane);
    }
    if (lane == 0) out[base + n0 + k] = r;
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
  gather_dot_cand_kernel<C, V, kQuant><<<(unsigned)blocks, kWarps * 32, 0,
                                         stream>>>(
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
  // tile_n in [1, 256]: one thread of the block reads each tile id
  if (tile_n < 1 || tile_n > kWarps * 32) return (int)cudaErrorInvalidValue;
  GATHER_DOT_DISPATCH(launch_cand, q, cand, fwd_coords, fwd_vals, fwd_scale,
                      fwd_zero, out, Q, n_cand, tile_n, n_docs, nnz, d,
                      stream)
}
