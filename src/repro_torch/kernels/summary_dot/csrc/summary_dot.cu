// summary_dot.cu: the router's quantized summary dots, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/summary_dot/summary_dot.py,
// _summary_dot_kernel launched by summary_dot_batch_pallas. For the whole
// query batch it computes
//
//   r[q, l] = sum_s q_dense[q, coords[q, l, s]] * deq(levels[q, l, s])
//   deq(u)  = (u - 1) * scale[q, l] + zero[q, l]  for u > 0,  0 for u == 0
//
// over the flattened (probed list, block) axis l.
//
// Bound on an H100: bytes. Every summary entry is 5 bytes (i32 coord and
// u8 level) and buys 2 flops. At the router's shapes (Q = 256,
// L = cut * n_blocks = 4940, S = 96) the inputs are 121.4 M entries, about
// 0.65 GB with q, scale, zero and the output: at least 0.19 ms at
// 3.35 TB/s, against 0.24 GFLOP of arithmetic.
//
// Design, simple and right first: one warp per output element. Lanes stride
// the S axis, so coords and levels are read coalesced; the q_dense gather
// goes through the read-only path (__ldg) and is served by L2 (q_dense is
// 31 MB at Q = 256, inside the 50 MB L2). The TPU kernel kept a
// [tile_q, d] query tile resident in VMEM; one f32 row at d = 30522 is
// 122 KB, so no useful query tile fits in shared memory and q is not
// staged here. The row dot is the shared one of row_dot.cuh (lane-strided
// sums, a warp-shuffle tree), so the fused routers score a summary row
// bitwise as this kernel does; lane 0 stores. The launch allocates
// nothing and runs on the caller's stream; the C entry point returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_dot.cuh"

namespace {

constexpr int kWarps = 8;  // output elements per 256-thread block

__global__ void __launch_bounds__(kWarps * 32)
summary_dot_kernel(const float* __restrict__ q,
                   const int32_t* __restrict__ coords,
                   const uint8_t* __restrict__ levels,
                   const float* __restrict__ scale,
                   const float* __restrict__ zero, float* __restrict__ out,
                   long long rows, int L, int S, int d) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float acc = seismic::row_dot<int32_t, uint8_t, true>(
      q + (row / L) * (long long)d, coords + row * S, levels + row * S, S,
      scale[row], zero[row], lane);
  if (lane == 0) out[row] = acc;
}

}  // namespace

extern "C" int summary_dot_launch(const float* q, const int32_t* coords,
                                  const uint8_t* levels, const float* scale,
                                  const float* zero, float* out, int Q, int L,
                                  int S, int d, cudaStream_t stream) {
  const long long rows = (long long)Q * L;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  summary_dot_kernel<<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      q, coords, levels, scale, zero, out, rows, L, S, d);
  return (int)cudaGetLastError();
}
