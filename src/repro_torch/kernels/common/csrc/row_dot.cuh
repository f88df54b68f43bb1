// row_dot.cuh: the one sparse-row dot product that every kernel of the
// query path uses (summary_dot, gather_dot, gather_dot_cand, router_flat,
// router_hier, refine_round).
//
//   <q_row, row> = sum_j q_row[c[j]] * x[j]
//   x[j] = v[j] (f32 or bf16), or for u8 levels
//   x[j] = (v[j] - 1) * scale + zero with level 0 -> 0
//
// One warp computes one row: lane i sums entries i, i + 32, ... and a
// butterfly of warp shuffles adds the 32 lane sums, so every lane returns
// the same total. Because every kernel sums a row in exactly this order,
// a summary or document row scores bitwise the same in each of them: the
// unfused stages (fuse level 0), the candidate-driven scorer (level 1)
// and the fused router and refine kernels (level 2) agree to the bit.
// The q lookup goes through the read-only path (__ldg); QMasked answers a
// coordinate the query lacks from a shared-memory bitmap instead.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace seismic {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// q_row[c] read from L2 (q_dense lives there at the query path's shapes).
struct QRow {
  const float* __restrict__ q;
  __device__ __forceinline__ float operator()(int c) const {
    return __ldg(q + c);
  }
};

// q_row[c] for a row whose non-zeros (any bit pattern but +0.0) bits
// marks: a miss is exactly q_dense's +0.0, without a trip to L2, so a
// row dot with QMasked is bitwise the one with QRow.
struct QMasked {
  const float* __restrict__ q;
  const uint32_t* bits;           // shared memory, one bit per coordinate
  __device__ __forceinline__ float operator()(int c) const {
    return (bits[c >> 5] >> (c & 31)) & 1u ? __ldg(q + c) : 0.0f;
  }
};

// Marks q_row's non-zeros in the 32-coordinate words [w_begin, w_end) of
// a bitmap: put(w, mask) stores word w. n_warps warps (this one is
// `warp`) read the row coalesced, U words per warp at once, and one
// ballot makes each word.
template <typename Put>
__device__ __forceinline__ void mark_nonzeros(const float* __restrict__ qrow,
                                              int d, int w_begin, int w_end,
                                              int warp, int n_warps, int lane,
                                              Put put) {
  constexpr int U = 16;
  for (int w0 = w_begin + warp * U; w0 < w_end; w0 += n_warps * U) {
    float x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = (w0 + u) * 32 + lane;
      x[u] = w0 + u < w_end && c < d ? __ldg(qrow + c) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint32_t m =
          __ballot_sync(0xffffffffu, __float_as_uint(x[u]) != 0u);
      if (lane == 0 && w0 + u < w_end) put(w0 + u, m);
    }
  }
}

// <q_row, row_r> for R rows of n entries each, into out[r]; every lane of
// the warp returns the sums. C is int32_t or uint16_t, V float,
// __nv_bfloat16 or uint8_t; qv(c) returns q_row[c] (QRow, or a lookup
// that returns exactly q_row[c] in another way). The loop takes the
// entries in batches of K per lane: the batch's coords and values of all
// R rows are loaded, then their q lookups issued, then summed, so a warp
// keeps K * R loads in flight (the candidate scorer runs R = 2, K = 4);
// each row is still summed in the one order above, whatever R and the
// lookup are.
template <int R, int K, typename C, typename V, bool kQuant, typename Q>
__device__ __forceinline__ void row_dots(const Q& qv, const C* const* c,
                                         const V* const* v, int n,
                                         const float* scale,
                                         const float* zero, int lane,
                                         float* out) {
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  for (int j0 = lane; j0 < n; j0 += 32 * K) {
    // the batch's coords and values of all R rows, then their q lookups,
    // then the sums in entry order
    int col[K][R];
    float x[K][R], qx[K][R];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + 32 * k;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        col[k][r] = 0;
        x[k][r] = 0.0f;
        if (j < n) {
          col[k][r] = (int)c[r][j];
          if constexpr (kQuant) {
            const unsigned lv = v[r][j];
            x[k][r] = lv ? (float(lv) - 1.0f) * scale[r] + zero[r] : 0.0f;
          } else {
            x[k][r] = to_float(v[r][j]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int r = 0; r < R; ++r)
        qx[k][r] = j0 + 32 * k < n ? qv(col[k][r]) : 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (j0 + 32 * k < n)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] += qx[k][r] * x[k][r];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = warp_sum(acc[r]);
}

// <q_row, row> for one row of n entries (row_dots with R = K = 1, QRow).
template <typename C, typename V, bool kQuant>
__device__ __forceinline__ float row_dot(const float* __restrict__ qrow,
                                         const C* __restrict__ c,
                                         const V* __restrict__ v, int n,
                                         float scale, float zero, int lane) {
  const C* cs[1] = {c};
  const V* vs[1] = {v};
  float out[1];
  row_dots<1, 1, C, V, kQuant>(QRow{qrow}, cs, vs, n, &scale, &zero, lane,
                               out);
  return out[0];
}

}  // namespace seismic
