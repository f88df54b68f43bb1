// router_fused.cu: the fused router (Seismic phase R in one launch), for
// Hopper (sm_90a).
//
// Replaces the two TPU kernels of src/repro/kernels/router_fused/
// router_fused.py:
//
// * router_flat_pallas (_router_flat_kernel): for the probed lists
//   lists[q, cut] it scores every block summary of every probed list,
//     r[q, l] = <q, deq(summary[lists[q, l / nb], l % nb])>,
//   with dead blocks (block_len == 0) at -inf, reading the summary rows
//   straight from the [L, nb, S] planes: the unfused router's
//   [Q, cut * nb, S] gather never exists;
// * router_hier_pallas (_router_hier_kernel): stage A scores the
//   superblock tier of the probed lists (cut * ns rows of S2 entries,
//   a superblock is dead when all its children are), keeps the top m
//   per query in lax.top_k order (score descending, lowest index first on
//   ties, -inf entries included), and stage B scores the m * fanout child
//   block summaries. It writes the child scores rb (-inf where the child
//   is out of range, dead, or under a dead superblock) and their flat
//   positions slot * nb + child; the host scatters them into the routed
//   [Q, cut * nb] layout with an amax (output-sized work).
//
// Bound on an H100: bytes. A summary entry is 5 bytes (i32 coord + u8
// level) and costs 4 flops (dequant and multiply-add). Counted once per
// distinct row, and only the rows a kernel reads: the flat route reads
// the block_len row of each distinct probed list and, for each of its
// live blocks, S * 5 bytes plus the scale and zero; the hierarchical
// route reads the same block_len rows, S2 * 5 bytes for each live
// superblock of a distinct probed list and S * 5 bytes for each distinct
// scored (list, block) child. Both read the q entries those rows name
// (one f32 per distinct query and coordinate) and write their outputs.
// At the smoke's shapes (Q = 256, d = 30522, nb = 494, ns = 62, S = 96,
// S2 = 768) a list's full tier is 237 KB of either kind.
//
// Design, simple and right first. Every summary row is scored by one warp
// with the shared row dot of row_dot.cuh, so a row scores bitwise as the
// summary_dot kernel scores it on the unfused path: fuse levels 0 and 2
// route identically, top-m choice included. The flat kernel has one warp
// per output element. The hierarchical kernel has one 256-thread block
// per query: its warps score stage A into shared memory, a bitonic sort
// over the stage-A scores padded to a power of two (padding at -inf with
// indices past the real ones) orders them by (score desc, index asc), and
// the warps score the first m superblocks' children. Shared memory is
// 8 bytes per padded stage-A entry (4 KB at cut 8, ns 62). The TPU kernel
// gathered the planes into VMEM tiles; here rows are read where they lie,
// through L2. No launch allocates; each runs on the caller's stream and
// its C entry point returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_dot.cuh"

namespace {

constexpr int kWarps = 8;              // warps per 256-thread block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSmem = 48 * 1024;    // without the opt-in attribute

using seismic::row_dot;

// a probed coordinate clipped into [0, L), as the TPU kernel's
// mode="clip" gather does
__device__ __forceinline__ long long clip_list(int v, int L) {
  return v < 0 ? 0 : (v >= L ? L - 1 : v);
}

__global__ void __launch_bounds__(kThreads)
router_flat_kernel(const int32_t* __restrict__ lists,
                   const float* __restrict__ q,
                   const int32_t* __restrict__ sum_coords,
                   const uint8_t* __restrict__ sum_q,
                   const float* __restrict__ sum_scale,
                   const float* __restrict__ sum_zero,
                   const int32_t* __restrict__ block_len,
                   float* __restrict__ out, long long rows, int cut, int L,
                   int nb, int S, int d) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long per_q = (long long)cut * nb;
  const long long qi = row / per_q;
  const int l = (int)(row - qi * per_q);
  const long long srow = clip_list(lists[qi * cut + l / nb], L) * nb
                         + l % nb;
  float r = -INFINITY;
  if (block_len[srow] > 0)              // the same for the whole warp
    r = row_dot<int32_t, uint8_t, true>(q + qi * d, sum_coords + srow * S,
                                        sum_q + srow * S, S, sum_scale[srow],
                                        sum_zero[srow], lane);
  if (lane == 0) out[row] = r;
}

// a comes before b in lax.top_k order
__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

__global__ void __launch_bounds__(kThreads)
router_hier_kernel(const int32_t* __restrict__ lists,
                   const float* __restrict__ q,
                   const int32_t* __restrict__ sup_coords,
                   const uint8_t* __restrict__ sup_q,
                   const float* __restrict__ sup_scale,
                   const float* __restrict__ sup_zero,
                   const int32_t* __restrict__ sum_coords,
                   const uint8_t* __restrict__ sum_q,
                   const float* __restrict__ sum_scale,
                   const float* __restrict__ sum_zero,
                   const int32_t* __restrict__ block_len,
                   float* __restrict__ rb, int32_t* __restrict__ flat,
                   int cut, int L, int ns, int S2, int nb, int S, int m,
                   int fanout, int P, int d) {
  extern __shared__ float smem[];
  float* u = smem;                                  // [P] stage-A scores
  int* ui = reinterpret_cast<int*>(smem + P);       // [P] their indices
  const long long qi = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qrow = q + qi * d;
  const int32_t* ql = lists + qi * cut;
  const int n_sup = cut * ns;

  // ---- stage A: the superblock tier of the probed lists
  for (int i = warp; i < P; i += kWarps) {
    float s = -INFINITY;
    if (i < n_sup) {
      const long long lst = clip_list(ql[i / ns], L);
      const int g = i % ns;
      const int c1 = min(g * fanout + fanout, nb);
      bool alive = false;               // any child block live
      for (int c = g * fanout; c < c1; ++c)
        alive |= block_len[lst * nb + c] > 0;
      if (alive) {
        const long long srow = lst * ns + g;
        s = row_dot<int32_t, uint8_t, true>(
            qrow, sup_coords + srow * S2, sup_q + srow * S2, S2,
            sup_scale[srow], sup_zero[srow], lane);
      }
    }
    if (lane == 0) {
      u[i] = s;
      ui[i] = i;
    }
  }
  __syncthreads();

  // ---- top-m: bitonic sort of the P entries into lax.top_k order
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += kThreads) {
        const int p = i ^ j;
        if (p > i) {
          const float si = u[i], sp = u[p];
          const int ii = ui[i], ip = ui[p];
          const bool swap = ((i & k) == 0) ? before(sp, ip, si, ii)
                                           : before(si, ii, sp, ip);
          if (swap) {
            u[i] = sp;
            u[p] = si;
            ui[i] = ip;
            ui[p] = ii;
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- stage B: the children of the top-m superblocks
  const int n_out = m * fanout;
  for (int t = warp; t < n_out; t += kWarps) {
    const int j = t / fanout;
    const int sid = ui[j];
    const float us = u[j];
    const int li = sid / ns;
    int child = (sid % ns) * fanout + t % fanout;
    const bool in_range = child < nb;
    child = min(child, nb - 1);
    const long long brow = clip_list(ql[li], L) * nb + child;
    float r = -INFINITY;
    if (in_range && block_len[brow] > 0 && isfinite(us))
      r = row_dot<int32_t, uint8_t, true>(qrow, sum_coords + brow * S,
                                          sum_q + brow * S, S,
                                          sum_scale[brow], sum_zero[brow],
                                          lane);
    if (lane == 0) {
      rb[qi * n_out + t] = r;
      flat[qi * n_out + t] = li * nb + child;
    }
  }
}

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" int router_flat_launch(const int32_t* lists, const float* q,
                                  const int32_t* sum_coords,
                                  const uint8_t* sum_q,
                                  const float* sum_scale,
                                  const float* sum_zero,
                                  const int32_t* block_len, float* out, int Q,
                                  int cut, int L, int nb, int S, int d,
                                  cudaStream_t stream) {
  const long long rows = (long long)Q * cut * nb;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  router_flat_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      lists, q, sum_coords, sum_q, sum_scale, sum_zero, block_len, out, rows,
      cut, L, nb, S, d);
  return (int)cudaGetLastError();
}

extern "C" int router_hier_launch(
    const int32_t* lists, const float* q, const int32_t* sup_coords,
    const uint8_t* sup_q, const float* sup_scale, const float* sup_zero,
    const int32_t* sum_coords, const uint8_t* sum_q, const float* sum_scale,
    const float* sum_zero, const int32_t* block_len, float* rb,
    int32_t* flat, int Q, int cut, int L, int ns, int S2, int nb, int S,
    int m, int fanout, int d, cudaStream_t stream) {
  const int n_sup = cut * ns;
  if (m < 1 || m > n_sup || fanout < 1) return (int)cudaErrorInvalidValue;
  const int P = next_pow2(n_sup);
  const size_t smem = (size_t)P * (sizeof(float) + sizeof(int));
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  router_hier_kernel<<<(unsigned)Q, kThreads, smem, stream>>>(
      lists, q, sup_coords, sup_q, sup_scale, sup_zero, sum_coords, sum_q,
      sum_scale, sum_zero, block_len, rb, flat, cut, L, ns, S2, nb, S, m,
      fanout, P, d);
  return (int)cudaGetLastError();
}
