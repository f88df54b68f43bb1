// flash_attention.cu: online-softmax attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py,
// _fa_kernel launched by flash_attention_pallas. For q [B, Hq, Sq, D] and
// k, v [B, Hkv, Sk, D] (Hq % Hkv == 0; kv head h / (Hq / Hkv) serves q head
// h, the JAX wrapper's repeat done as an index) it computes
//
//   o[q] = sum_k p[q, k] v[k] / sum_k p[q, k],   p = exp(s - max_k s)
//   s[q, k] = (q . k) * sm_scale  where the key is live, -1e30 elsewhere
//   live: k < Sk, and k <= q if causal, and k > q - window if a window
//
// in q's dtype, float32 or bf16, with the running max, denominator and
// accumulator in float32; a row with no live key is 0.
//
// Bound on an H100: operations at the model's shapes. At llama3-8b's
// prefill (B 1, Hq 32, Hkv 8, S 8192, D 128, causal) the two products are
// 2 * S^2 * D * Hq = 0.55 TFLOP against 168 MB of q, k, v and o: 0.56 ms
// at 989 TFLOP/s (bf16 tensor cores) against 0.050 ms at 3.35 TB/s.
//
// Design, simple and right first. The TPU kernel carries (m, l, acc) in
// VMEM scratch across a sequential k grid axis; here one block owns one
// (batch * head, 64-row q tile) and loops over the key tiles itself,
// skipping the tiles past the causal diagonal and before the window's
// first live key. A masked score's p is set to 0 explicitly (not left to
// exp(-1e30 - m)), so a row that meets a fully masked tile first carries
// nothing into its first live key, and a row with no live key ends with
// l = 0 and writes 0 (the l == 0 -> 1 guard of the TPU kernel). Keys at or
// past Sk are staged as zeros and masked; rows at or past Sq are not
// stored, so no input is padded. Strides come from the wrapper (the D
// axis is contiguous), so q, k and v are read in place from the model's
// [B, S, H, D] projections.
//
// * bf16: 4 warps, 16 q rows each, with Q held in registers as mma.sync
//   m16n8k16 A fragments. K and V tiles of 64 x D are staged in shared
//   memory (16 KB each at D = 128), rows padded by 8 elements so the
//   fragment loads hit 32 distinct banks. S = Q K^T and O += P V run on
//   the tensor cores (bf16 in, float32 accumulate). P enters P V in bf16,
//   as the score accumulators are repacked into A fragments without a
//   trip through shared memory; this rounds each p by at most 2^-9
//   relative, so o[q, d] moves by at most 2^-9 * sum_k p |v[k, d]| /
//   sum_k p against the plain version's float32 P V: chip_smoke.py holds
//   each element to twice that plus one bf16 ulp of rounding. The
//   denominator sums the float32 p.
// * float32: FMA outside the tensor cores (the kernel's float32 tests and
//   checks, not the model's bf16 path). 64 q rows x 4 lanes per block;
//   lane c of a row holds dims c, c + 4, ... of q and the accumulator, a
//   score is the 4 lanes' partial dots summed by two shuffles; 32-key K
//   and V tiles in shared memory. P V in float32.
//
// D is a template parameter, 16, 32, 64 or 128; the launch returns
// cudaErrorInvalidValue for any other. It allocates nothing, runs on the
// caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;       // q rows per block, both kernels
constexpr int kWarps = 4;         // bf16: 16 q rows per warp
constexpr int kBlockK = 64;       // bf16: keys per shared-memory tile
constexpr int kBlockK32 = 32;     // float32: keys per shared-memory tile
constexpr float kNeg = -1e30f;

struct Shape {
  int hq, group, sq, sk;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
  int causal, window;             // window <= 0: none
};

__device__ __forceinline__ bool live(const Shape& s, int qp, int kp) {
  return kp < s.sk && (!s.causal || kp <= qp) &&
         (s.window <= 0 || kp > qp - s.window);
}

// Key tiles [*t0, *t1) that hold a live key of some q row in [q_lo, q_hi].
__device__ __forceinline__ void tile_range(const Shape& s, int q_lo, int q_hi,
                                           int bk, int* t0, int* t1) {
  const int k_end = s.causal ? min(s.sk, q_hi + 1) : s.sk;
  const int k_begin = s.window > 0 ? max(0, q_lo - s.window + 1) : 0;
  *t0 = k_begin / bk;
  *t1 = k_end > k_begin ? (k_end + bk - 1) / bk : *t0;
}

// ------------------------------------------------------------------ bf16

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// c += a (16 x 16, row) * b (16 x 8, col): bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
fa_bf16_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, Shape s) {
  constexpr int kPad = D + 8;     // shared row stride: conflict-free frags
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK][kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK][kPad];

  const int bh = blockIdx.x;
  const int b = bh / s.hq, h = bh % s.hq, hk = h / s.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // longest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int w0 = q0 + warp * 16;
  const int r0 = w0 + g, r1 = r0 + 8;     // this thread's two q rows

  const __nv_bfloat16* qb = q + b * s.q_sb + h * s.q_sh;
  const __nv_bfloat16* kb = k + b * s.k_sb + hk * s.k_sh;
  const __nv_bfloat16* vb = v + b * s.v_sb + hk * s.v_sh;

  // Q as A fragments: rows r0 / r1, columns 16 kk + 2 t (+1, +8, +9)
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t * 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (i & 1) ? r1 : r0;
      const int cc = c + ((i & 2) ? 8 : 0);
      qf[kk][i] = r < s.sq ? *reinterpret_cast<const uint32_t*>(
                                 qb + r * s.q_ss + cc)
                           : 0u;
    }
  }

  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};        // this lane's part of each row's sum
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int t0, t1;
  tile_range(s, q0, min(q0 + kBlockQ, s.sq) - 1, kBlockK, &t0, &t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();              // every warp is done with the last tile
    constexpr int kVec = D / 8;   // 16-byte vectors per row
    for (int i = threadIdx.x; i < kBlockK * kVec; i += kWarps * 32) {
      const int r = i / kVec, c = (i % kVec) * 8;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (k0 + r < s.sk) {
        kx = *reinterpret_cast<const uint4*>(kb + (k0 + r) * s.k_ss + c);
        vx = *reinterpret_cast<const uint4*>(vb + (k0 + r) * s.v_ss + c);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kx;
      *reinterpret_cast<uint4*>(&vs[r][c]) = vx;
    }
    __syncthreads();
    if (s.causal && k0 > w0 + 15) continue;  // all of this warp's keys masked

    // S = Q K^T: 8 column tiles of 8 keys
    float sc[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
        const __nv_bfloat16* kr = &ks[n * 8 + g][kk * 16 + t * 2];
        mma_bf16(sc[n], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale and mask; new running max of rows r0 (i = 0) and r1 (i = 1)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + n * 8 + t * 2 + (j & 1);
        const int i = j >> 1;
        const float x = live(s, i ? r1 : r0, kp) ? sc[n][j] * s.scale : kNeg;
        sc[n][j] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + n * 8 + t * 2 + (j & 1);
        const int i = j >> 1;
        const float p = live(s, i ? r1 : r0, kp) ? expf(sc[n][j] - m[i]) : 0.f;
        sc[n][j] = p;
        l[i] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: the score tiles 2j, 2j + 1 are the A fragment of keys
    // 16 j .. 16 j + 15; V's B fragment is read as key pairs
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                             pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                             pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                             pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
      const int key = j * 16 + t * 2;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + g;
        mma_bf16(acc[n], a, pack_raw(vs[key][col], vs[key + 1][col]),
                 pack_raw(vs[key + 8][col], vs[key + 9][col]));
      }
    }
  }

  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    den[i] = l[i] == 0.f ? 1.f : l[i];    // a row with no live key -> 0
  }
  __nv_bfloat16* ob = o + b * s.o_sb + h * s.o_sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + t * 2;
    if (r0 < s.sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * s.o_ss + col) =
          pack_bf16(acc[n][0] / den[0], acc[n][1] / den[0]);
    if (r1 < s.sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * s.o_ss + col) =
          pack_bf16(acc[n][2] / den[1], acc[n][3] / den[1]);
  }
}

// --------------------------------------------------------------- float32

template <int D>
__global__ void __launch_bounds__(kBlockQ * 4)
fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Shape s) {
  constexpr int kPer = D / 4;     // dims per lane
  __shared__ __align__(16) float ks[kBlockK32][D];
  __shared__ __align__(16) float vs[kBlockK32][D];

  const int bh = blockIdx.x;
  const int b = bh / s.hq, h = bh % s.hq, hk = h / s.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int part = threadIdx.x & 3;
  const int qp = q0 + (threadIdx.x >> 2);

  const float* qb = q + b * s.q_sb + h * s.q_sh;
  const float* kb = k + b * s.k_sb + hk * s.k_sh;
  const float* vb = v + b * s.v_sb + hk * s.v_sh;

  float qr[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qr[i] = qp < s.sq ? qb[qp * s.q_ss + part + 4 * i] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNeg, l = 0.f;

  int t0, t1;
  tile_range(s, q0, min(q0 + kBlockQ, s.sq) - 1, kBlockK32, &t0, &t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * kBlockK32;
    __syncthreads();
    constexpr int kVec = D / 4;   // 16-byte vectors per row
    for (int i = threadIdx.x; i < kBlockK32 * kVec; i += kBlockQ * 4) {
      const int r = i / kVec, c = (i % kVec) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < s.sk) {
        kx = *reinterpret_cast<const float4*>(kb + (k0 + r) * s.k_ss + c);
        vx = *reinterpret_cast<const float4*>(vb + (k0 + r) * s.v_ss + c);
      }
      *reinterpret_cast<float4*>(&ks[r][c]) = kx;
      *reinterpret_cast<float4*>(&vs[r][c]) = vx;
    }
    __syncthreads();

    float sc[kBlockK32];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kBlockK32; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) d = fmaf(qr[i], ks[j][part + 4 * i], d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      sc[j] = live(s, qp, k0 + j) ? d * s.scale : kNeg;
      mx = fmaxf(mx, sc[j]);
    }
    const float corr = expf(m - mx);
    m = mx;
    l *= corr;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBlockK32; ++j) {
      const float p = live(s, qp, k0 + j) ? expf(sc[j] - m) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = fmaf(p, vs[j][part + 4 * i], acc[i]);
    }
  }

  if (qp < s.sq) {
    const float den = l == 0.f ? 1.f : l;  // a row with no live key -> 0
    float* orow = o + b * s.o_sb + h * s.o_sh + qp * s.o_ss;
#pragma unroll
    for (int i = 0; i < kPer; ++i) orow[part + 4 * i] = acc[i] / den;
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, int bf16,
            dim3 grid, const Shape& s, cudaStream_t stream) {
  if (bf16)
    fa_bf16_kernel<D><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), s);
  else
    fa_f32_kernel<D><<<grid, kBlockQ * 4, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), s);
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) of q, k, v and o.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bf16, int B,
                                      int Hq, int Hkv, int Sq, int Sk, int D,
                                      const long long* strides, float scale,
                                      int causal, int window,
                                      cudaStream_t stream) {
  const long long* st = strides;
  const Shape s{Hq,    Hq / Hkv, Sq,    Sk,    st[0],  st[1],  st[2],
                st[3], st[4],    st[5], st[6], st[7],  st[8],  st[9],
                st[10], st[11],  scale, causal, window};
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + kBlockQ - 1) / kBlockQ));
  switch (D) {
    case 16: launch<16>(q, k, v, o, bf16, grid, s, stream); break;
    case 32: launch<32>(q, k, v, o, bf16, grid, s, stream); break;
    case 64: launch<64>(q, k, v, o, bf16, grid, s, stream); break;
    case 128: launch<128>(q, k, v, o, bf16, grid, s, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
