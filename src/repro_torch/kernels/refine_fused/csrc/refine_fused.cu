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
// 256 queries that is a few MB: the launch, not the bytes, sets its time
// at these shapes.
//
// Design, simple and right first: one 256-thread block per query. The
// expansion is written to shared memory padded to a power of two with
// INT_MAX (which sorts after every id and the sentinel), a bitonic sort
// orders it, each thread dedupes and seen-masks its entries into a second
// shared buffer (the seen row is read through L1), a second bitonic sort
// compacts, and the warps score the candidates with the shared row dot
// of row_dot.cuh, the one gather_dot_cand uses: fuse levels 0, 1 and 2
// rescore a document bitwise alike. Shared memory is 8 bytes per padded
// candidate (1 KB at C = 80). No launch allocates; each runs on the
// caller's stream and its C entry point returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "row_dot.cuh"

namespace {

constexpr int kWarps = 8;              // warps per 256-thread block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSmem = 48 * 1024;    // without the opt-in attribute

using seismic::row_dot;

// ascending bitonic sort of P (a power of two) ints in shared memory
__device__ __forceinline__ void bitonic_sort(int* key, int P) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += kThreads) {
        const int p = i ^ j;
        if (p > i) {
          const int a = key[i], b = key[p];
          if ((a > b) == ((i & k) == 0)) {
            key[i] = b;
            key[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

template <typename C, typename V, bool kQuant>
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
                    int nnz, int P, int d) {
  extern __shared__ int smem[];
  int* key = smem;              // [P] the expansion, then its sort
  int* front = smem + P;        // [P] deduped, seen-masked, then compacted
  const long long qi = blockIdx.x;
  const int n_cand = k * degree;

  // ---- 1. expand
  for (int t = threadIdx.x; t < P; t += kThreads) {
    int v = INT_MAX;
    if (t < n_cand) {
      const int id = ids[qi * k + t / degree];
      if (id < 0) {
        v = n_docs;
      } else {
        const long long doc = id < n_docs ? id : n_docs - 1;
        v = knn[doc * knn_deg + t % degree];
      }
    }
    key[t] = v;
  }
  __syncthreads();
  bitonic_sort(key, P);

  // ---- 2 and 3. dedupe against the left neighbour, then the seen set
  const int32_t* seen = scored + qi * W;
  for (int t = threadIdx.x; t < P; t += kThreads) {
    int v = key[t];
    if (t < n_cand) {
      if (t > 0 && v == key[t - 1]) v = n_docs;
      for (int w = 0; w < W && v != n_docs; ++w)
        if (__ldg(seen + w) == v) v = n_docs;
    }
    front[t] = v;
  }
  __syncthreads();

  // ---- 4. compact: live ids to a sorted prefix
  bitonic_sort(front, P);

  // ---- 5. exact rescore of the live frontier
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qrow = q + qi * d;
  for (int t = warp; t < n_cand; t += kWarps) {
    const int id = front[t];
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
    if (lane == 0) {
      cand[qi * n_cand + t] = id;
      out[qi * n_cand + t] = r;
    }
  }
}

template <typename C, typename V, bool kQuant>
int launch(const int32_t* ids, const int32_t* scored, const float* q,
           const int32_t* knn, const void* fwd_coords, const void* fwd_vals,
           const float* fwd_scale, const float* fwd_zero, int32_t* cand,
           float* out, int Q, int k, int W, int degree, int knn_deg,
           int n_docs, int nnz, int d, cudaStream_t stream) {
  int P = 1;
  while (P < k * degree) P <<= 1;
  const size_t smem = (size_t)P * 2 * sizeof(int);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  refine_round_kernel<C, V, kQuant><<<(unsigned)Q, kThreads, smem, stream>>>(
      ids, scored, q, knn, static_cast<const C*>(fwd_coords),
      static_cast<const V*>(fwd_vals), fwd_scale, fwd_zero, cand, out, k, W,
      degree, knn_deg, n_docs, nnz, P, d);
  return (int)cudaGetLastError();
}

}  // namespace

// coord_kind: 0 = int32, 1 = uint16.
// val_kind:   0 = float32, 1 = bfloat16, 2 = uint8 with per-row dequant.
extern "C" int refine_round_launch(
    const int32_t* ids, const int32_t* scored, const float* q,
    const int32_t* knn, const void* fwd_coords, const void* fwd_vals,
    const float* fwd_scale, const float* fwd_zero, int32_t* cand, float* out,
    int Q, int k, int W, int degree, int knn_deg, int n_docs, int nnz, int d,
    int coord_kind, int val_kind, cudaStream_t stream) {
  if (k < 1 || degree < 1 || degree > knn_deg || n_docs < 1)
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
