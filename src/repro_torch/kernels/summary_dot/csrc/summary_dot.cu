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
// staged here. A warp-shuffle tree reduces the lane sums; lane 0 stores.
// The launch allocates nothing and runs on the caller's stream; the C entry
// point returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // output elements per 256-thread block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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
  const float* qrow = q + (row / L) * (long long)d;
  const int32_t* c = coords + row * S;
  const uint8_t* u = levels + row * S;
  const float sc = scale[row];
  const float z = zero[row];
  float acc = 0.0f;
  for (int j = lane; j < S; j += 32) {
    const unsigned lv = u[j];
    const float deq = lv ? (float(lv) - 1.0f) * sc + z : 0.0f;
    acc += __ldg(qrow + c[j]) * deq;
  }
  acc = warp_sum(acc);
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
