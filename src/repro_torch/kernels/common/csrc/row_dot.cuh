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
// The q gather goes through the read-only path (__ldg); q_dense lives in
// L2 at the query path's shapes.
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

// <q_row, row> for one row of n entries; every lane of the warp returns
// the sum. C is int32_t or uint16_t, V float, __nv_bfloat16 or uint8_t.
template <typename C, typename V, bool kQuant>
__device__ __forceinline__ float row_dot(const float* __restrict__ qrow,
                                         const C* __restrict__ c,
                                         const V* __restrict__ v, int n,
                                         float scale, float zero, int lane) {
  float acc = 0.0f;
  for (int j = lane; j < n; j += 32) {
    float x;
    if constexpr (kQuant) {
      const unsigned lv = v[j];
      x = lv ? (float(lv) - 1.0f) * scale + zero : 0.0f;
    } else {
      x = to_float(v[j]);
    }
    acc += __ldg(qrow + (int)c[j]) * x;
  }
  return warp_sum(acc);
}

}  // namespace seismic
