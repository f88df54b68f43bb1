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
// Common to the three kernels below. The TPU kernel carries (m, l, acc)
// in VMEM scratch across a sequential k grid axis; here one block owns one
// (batch * head, q tile) and loops over the key tiles itself, skipping
// the tiles past the causal diagonal and before the window's first live
// key. A masked score's p is exactly 0 (not left to exp(-1e30 - m)), so a
// row that meets a fully masked tile first carries nothing into its first
// live key, and a row with no live key ends with l = 0 and writes 0 (the
// l == 0 -> 1 guard of the TPU kernel). Keys at or past Sk arrive as zeros
// and are masked; rows at or past Sq are not stored, so no input is
// padded. q, k and v are read in place from the model's [B, S, H, D]
// projections (the D axis contiguous, the other strides from the wrapper).
// P enters P V in bf16 on the bf16 paths (the score accumulators repacked
// as the next product's A fragments, never through shared memory): this
// rounds each p by at most 2^-9 relative, so o[q, d] moves by at most
// 2^-9 * sum_k p |v[k, d]| / sum_k p against the plain version's float32
// P V; chip_smoke.py holds each element to twice that plus one bf16 ulp.
// The denominator sums the float32 p.
//
// * bf16, D 64, 112 and 128 (the models' heads): fa_wgmma_kernel, the
//   Hopper design. A block of three warpgroups owns a 128-row q tile.
//   Warpgroup 0 is the producer: it gives up registers (setmaxnreg.dec)
//   and one thread issues TMA loads, Q once and then K and V tiles of 128
//   keys x D into a two-stage ring in dynamic shared memory, each stage
//   guarded by a full and an empty mbarrier. The tensor maps (built by the
//   C entry point from the wrapper's dims, byte strides and box) read
//   [B, H, S, D] views in place as 4-D (D, S, H, B) tensors, in 64-column
//   boxes with the 128-byte swizzle that wgmma's shared-memory descriptors
//   read directly. The two consumer warpgroups (setmaxnreg.inc) own 64 q
//   rows each: S = Q K^T is wgmma m64n128k16 with both operands in shared
//   memory; O += P V is wgmma m64nDk16 (n 128 at D 112) with P in
//   registers and V read through the transpose bit. The softmax runs in base 2: one multiply by sm_scale * log2(e),
//   then exp2f. Each warpgroup classifies a key tile as full (every
//   pair live: no mask test), edge (the diagonal, a window's edge, Sk:
//   one live() per score, masked scores -inf so exp2 gives exactly 0) or
//   empty of live pairs (no product; it still releases the stage).
//   D 112 (kimi-k2's heads): the tensor maps keep the real D, so the rows
//   of 224 B are read in place, and a tile row is two 64-column boxes
//   whose second runs 16 columns past D: TMA fills columns 112-127 with
//   zeros and still counts the whole box's bytes, as for keys at or past
//   Sk. Tiles, shared memory and the accumulator are those of D 128. Q K^T
//   takes D / 16 = 7 k-steps (an eighth would add zeros); P V stays
//   m64n128k16, since V is read through the transpose bit, whose 128-byte
//   swizzled layout repeats in 64-column atoms (112 columns are not whole
//   atoms), and its columns 112-127 (zeros) are never stored. Bound:
//   operations, 4 * D * Hq * live pairs at 989 TFLOP/s (0.97 ms at
//   kimi-k2's prefill, [1, 64 / 8, 8192, 112]); the padded P V makes the
//   tensor cores do (112 + 128) / 224 = 1.07x that.
// * bf16, D 16 and 32: fa_bf16_kernel, 4 warps of 16 q rows each over
//   64-row q tiles, Q in registers as mma.sync m16n8k16 A fragments, K
//   and V tiles of 64 x D staged synchronously in shared memory with rows
//   padded by 8 elements (conflict-free fragment loads: a padded row is
//   D + 8 halves, 12 or 20 words, so the 8 rows of a fragment load start
//   on 8 distinct 4-word bank groups).
// * float32: FMA outside the tensor cores (the kernel's float32 tests and
//   checks, not the model's bf16 path). 64 q rows x 4 lanes per block;
//   lane c of a row holds dims c, c + 4, ... of q and the accumulator, a
//   score is the 4 lanes' partial dots summed by two shuffles; 32-key K
//   and V tiles in shared memory. P V in float32.
//
// q tiles are launched longest first (the causal diagonal's last tiles).
// No launch allocates; each runs on the caller's stream and returns
// cudaGetLastError() (a failed tensor-map encoding returns 1000 + its
// CUresult).
#include <cuda.h>
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

__device__ __forceinline__ bool live_at(int sk, int causal, int window,
                                        int qp, int kp) {
  return kp < sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

__device__ __forceinline__ bool live(const Shape& s, int qp, int kp) {
  return live_at(s.sk, s.causal, s.window, qp, kp);
}

// Key tiles [*t0, *t1) that hold a live key of some q row in [q_lo, q_hi].
__device__ __forceinline__ void tile_range(int sk, int causal, int window,
                                           int q_lo, int q_hi, int bk, int* t0,
                                           int* t1) {
  const int k_end = causal ? min(sk, q_hi + 1) : sk;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
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
  tile_range(s.sk, s.causal, s.window, q0, min(q0 + kBlockQ, s.sq) - 1,
             kBlockK, &t0, &t1);
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
  tile_range(s.sk, s.causal, s.window, q0, min(q0 + kBlockQ, s.sq) - 1,
             kBlockK32, &t0, &t1);
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

// -------------------------------------- bf16, D 64, 112 and 128: wgmma

constexpr int kTmaBlockQ = 128;   // q rows per block: 2 consumer groups of 64
constexpr int kTmaBlockK = 128;   // keys per K/V tile
constexpr int kStages = 2;        // K/V ring depth
constexpr int kBoxCols = 64;      // bf16 columns of one 128-byte swizzled row
constexpr int kBoxBytes = 128 * 128;  // one box: 128 rows x 128 bytes
constexpr int kThreads = 3 * 128;     // producer + two consumer warpgroups
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

enum TileKind { kEmpty, kEdge, kFull };

struct TmaShape {
  int hq, group, sq, sk;
  long long o_sb, o_sh, o_ss;
  float scale_log2;               // sm_scale * log2(e)
  int causal, window;
};

// The live pairs of q rows [r_lo, r_hi] x keys [k0, k0 + bk).
__device__ __forceinline__ TileKind tile_kind(const TmaShape& s, int r_lo,
                                              int r_hi, int k0, int bk) {
  const int k_hi = k0 + bk - 1;
  if (k0 >= s.sk || (s.causal && k0 > r_hi) ||
      (s.window > 0 && k_hi <= r_lo - s.window))
    return kEmpty;
  if (k_hi < s.sk && (!s.causal || k_hi <= r_lo) &&
      (s.window <= 0 || k0 > r_hi - s.window))
    return kFull;
  return kEdge;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box at coordinates (c0, c1, c2, c3) = (d, s, h, b) into dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at addr:
// lbo and sbo in bytes (sbo: between 8-row groups; lbo: between 64-column
// blocks of an MN-major operand, unused for K-major ones).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers an asynchronous wgmma reads or writes stay put (and are not
// read early) across this point.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define FA_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FA_D16(i) FA_D4(i), FA_D4(i + 4), FA_D4(i + 8), FA_D4(i + 12)
#define FA_D32 FA_D16(0), FA_D16(16)
#define FA_D64 FA_D32, FA_D16(32), FA_D16(48)

// d (64 x 128) = (accumulate ? d : 0) + A * B, A and B in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128) += A * B, A in registers, B in shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += A * B, A in registers, B in shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The columns of a tile row: D in whole 64-column boxes (128 at D 112).
template <int D>
__host__ __device__ constexpr int padded_d() {
  return (D + kBoxCols - 1) / kBoxCols * kBoxCols;
}

// O += P V over the padded width Dp (64 or 128).
template <int Dp>
__device__ __forceinline__ void wgmma_pv(float* acc, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (Dp == 128)
    wgmma_rs_n128(acc, a, db);
  else
    wgmma_rs_n64(acc, a, db);
}

// Dynamic shared memory: Q, then kStages x (K, V), then the barriers,
// plus room to align the start to the 1024 bytes the swizzle repeats in.
template <int D>
constexpr int wgmma_smem_bytes() {
  return (padded_d<D>() / kBoxCols) * kBoxBytes * (1 + 2 * kStages) + 64 +
         1024;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ o, const TmaShape s) {
  constexpr int kDp = padded_d<D>();               // columns of a tile row
  constexpr int kBoxes = kDp / kBoxCols;           // boxes per tile row
  constexpr uint32_t kTile = kBoxes * kBoxBytes;   // a Q, K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = q_s + kTile * (1 + 2 * kStages);
  const uint32_t q_full = bars;                   // then full[], empty[]
  const auto k_tile = [&](int st) { return q_s + kTile * (1 + 2 * st); };
  const auto full = [&](int st) { return bars + 8u * (1 + st); };
  const auto empty = [&](int st) { return bars + 8u * (1 + kStages + st); };

  const int bh = blockIdx.x;
  const int b = bh / s.hq, h = bh % s.hq, hk = h / s.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTmaBlockQ;  // longest first
  int t0, t1;
  tile_range(s.sk, s.causal, s.window, q0, min(q0 + kTmaBlockQ, s.sq) - 1,
             kTmaBlockK, &t0, &t1);
  const int n_tiles = t1 - t0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load of the block
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, kTile);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c)
        tma_load(q_s + c * kBoxBytes, &qmap, q_full, c * kBoxCols, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty(st), ((it / kStages) - 1) & 1);
        const uint32_t ks = k_tile(st), vs = ks + kTile;
        const int k0 = (t0 + it) * kTmaBlockK;
        mbar_expect_tx(full(st), 2 * kTile);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c) {
          tma_load(ks + c * kBoxBytes, &kmap, full(st), c * kBoxCols, k0, hk,
                   b);
          tma_load(vs + c * kBoxBytes, &vmap, full(st), c * kBoxCols, k0, hk,
                   b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns q rows q0 + 64 cw .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int g = (tid & 31) >> 2, t = tid & 3;
    const int r_lo = q0 + 64 * cw;
    const int r0 = r_lo + (tid >> 5) * 16 + g, r1 = r0 + 8;
    const float c = s.scale_log2;

    // accumulator layout (both products): element 4 j + e holds row r0
    // (e < 2) or r1, column 8 j + 2 t + (e & 1); columns past D stay 0
    float acc[kDp / 2];
#pragma unroll
    for (int i = 0; i < kDp / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNeg, kNeg};    // running max, in log2 units
    float l[2] = {0.f, 0.f};      // this lane's part of each row's sum

    if (n_tiles > 0) mbar_wait(q_full, 0);
    __syncwarp();                 // converged for the .aligned wgmma
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const int k0 = (t0 + it) * kTmaBlockK;
      const uint32_t ks = k_tile(st), vs = ks + kTile;
      mbar_wait(full(st), (it / kStages) & 1);
      __syncwarp();
      const TileKind kind = tile_kind(s, r_lo, r_lo + 63, k0, kTmaBlockK);
      if (kind != kEmpty) {
        // S = Q K^T: 64 x 128 per warpgroup, D / 16 steps of 16 columns
        float sc[kTmaBlockK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk / 4) * kBoxBytes + (kk % 4) * 32;
          wgmma_ss_n128(sc, smem_desc(q_s + col + cw * 64 * 128, 16, 1024),
                        smem_desc(ks + col, 16, 1024), kk > 0);
        }
        wgmma_commit_wait();
        hold(sc);

        // scores in log2 units; a masked one (edge tiles only) is -inf
#pragma unroll
        for (int i = 0; i < kTmaBlockK / 2; ++i) sc[i] *= c;
        if (kind == kEdge) {
#pragma unroll
          for (int i = 0; i < kTmaBlockK / 2; ++i) {
            const int kp = k0 + (i / 4) * 8 + 2 * t + (i & 1);
            if (!live_at(s.sk, s.causal, s.window, (i & 2) ? r1 : r0, kp))
              sc[i] = -INFINITY;
          }
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < kTmaBlockK / 2; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float mn = mx[r];
          corr[r] = exp2f(m[r] - mn);
          m[r] = mn;
          l[r] *= corr[r];
        }
        // p = 2^(s - m): exactly 0 for a masked score
#pragma unroll
        for (int i = 0; i < kTmaBlockK / 2; ++i) {
          const int r = (i >> 1) & 1;
          sc[i] = exp2f(sc[i] - m[r]);
          l[r] += sc[i];
        }
#pragma unroll
        for (int i = 0; i < kDp / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

        // O += P V: score columns 16 kk .. + 15 are the A fragment of
        // key step kk; V's 16 keys of the step start 16 rows down
        uint32_t pa[kTmaBlockK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kTmaBlockK / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTmaBlockK / 16; ++kk)
          wgmma_pv<kDp>(acc, pa[kk],
                      smem_desc(vs + kk * 16 * 128, kBoxBytes, 1024));
        wgmma_commit_wait();
        hold(acc);
        hold(pa);
      }
      mbar_arrive(empty(st));
    }

    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      den[r] = l[r] == 0.f ? 1.f : l[r];  // a row with no live key -> 0
    }
    __nv_bfloat16* ob = o + b * s.o_sb + h * s.o_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + t * 2;
      if (r0 < s.sq)
        *reinterpret_cast<uint32_t*>(ob + r0 * s.o_ss + col) =
            pack_bf16(acc[4 * j] / den[0], acc[4 * j + 1] / den[0]);
      if (r1 < s.sq)
        *reinterpret_cast<uint32_t*>(ob + r1 * s.o_ss + col) =
            pack_bf16(acc[4 * j + 2] / den[1], acc[4 * j + 3] / den[1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int bf16,
            dim3 grid, const Shape& s, cudaStream_t stream) {
  if (bf16) {
    if constexpr (D <= 32)  // D 64, 112 and 128 take fa_wgmma_kernel
      fa_bf16_kernel<D><<<grid, kWarps * 32, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(o), s);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    fa_f32_kernel<D><<<grid, kBlockQ * 4, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), s);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_wgmma(const CUtensorMap& qm, const CUtensorMap& km,
                 const CUtensorMap& vm, void* o, dim3 grid, const TmaShape& s,
                 cudaStream_t stream) {
  constexpr int kSmem = wgmma_smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      fa_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  fa_wgmma_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), s);
  return (int)cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map from one tensor's geometry: dims[4] (D, S, H, B),
// byte strides[3] (S, H, B), box[4]; 128-byte swizzle, zeros out of bounds.
int encode(CUtensorMap* map, const void* base, const long long* geo) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = (cuuint64_t)geo[i];
    box[i] = (cuuint32_t)geo[7 + i];
  }
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)geo[4 + i];
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

}  // namespace

// The wgmma kernel's build constants for head dim D, into out[7]: dynamic
// shared memory bytes, threads per block, the producer's and the
// consumers' registers (setmaxnreg), q rows per block, keys per K/V tile,
// bf16 columns per TMA box. Returns cudaErrorInvalidValue for another D.
extern "C" int flash_attention_wgmma_config(int D, int* out) {
  switch (D) {
    case 64: out[0] = wgmma_smem_bytes<64>(); break;
    case 112: out[0] = wgmma_smem_bytes<112>(); break;
    case 128: out[0] = wgmma_smem_bytes<128>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  out[1] = kThreads;
  out[2] = kProducerRegs;
  out[3] = kConsumerRegs;
  out[4] = kTmaBlockQ;
  out[5] = kTmaBlockK;
  out[6] = kBoxCols;
  return 0;
}

// bf16 with D 64, 112 or 128. geometry: 3 x 11 values, those of q, k and v
// (dims[4] as (D, S, H, B), byte strides[3] of S, H and B, box[4]), from
// ops.tma_geometry; o_strides: o's element strides (batch, head, seq).
// Every box must be the kernel's (kBoxCols, 128, 1, 1): the barriers
// expect a whole tile's bytes, so another box would never complete them.
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, const long long* geometry,
    const long long* o_strides, float scale, int causal, int window,
    cudaStream_t stream) {
  static_assert(kTmaBlockQ == kTmaBlockK, "one box serves Q, K and V");
  if (D != 64 && D != 112 && D != 128) return (int)cudaErrorInvalidValue;
  for (int t = 0; t < 3; ++t) {
    const long long* box = geometry + 11 * t + 7;
    if (box[0] != kBoxCols || box[1] != kTmaBlockQ || box[2] != 1 ||
        box[3] != 1)
      return (int)cudaErrorInvalidValue;
  }
  CUtensorMap qm, km, vm;
  int err = encode(&qm, q, geometry);
  if (err == 0) err = encode(&km, k, geometry + 11);
  if (err == 0) err = encode(&vm, v, geometry + 22);
  if (err != 0) return err;
  const TmaShape s{Hq,
                   Hq / Hkv,
                   Sq,
                   Sk,
                   o_strides[0],
                   o_strides[1],
                   o_strides[2],
                   (float)((double)scale * 1.4426950408889634),
                   causal,
                   window};
  const dim3 grid((unsigned)(B * Hq),
                  (unsigned)((Sq + kTmaBlockQ - 1) / kTmaBlockQ));
  switch (D) {
    case 64: return launch_wgmma<64>(qm, km, vm, o, grid, s, stream);
    case 112: return launch_wgmma<112>(qm, km, vm, o, grid, s, stream);
    default: return launch_wgmma<128>(qm, km, vm, o, grid, s, stream);
  }
}

// float32 (D 16, 32, 64, 112, 128) and bf16 with D 16 or 32.
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
    case 16: return launch<16>(q, k, v, o, bf16, grid, s, stream);
    case 32: return launch<32>(q, k, v, o, bf16, grid, s, stream);
    case 64: return launch<64>(q, k, v, o, bf16, grid, s, stream);
    case 112: return launch<112>(q, k, v, o, bf16, grid, s, stream);
    case 128: return launch<128>(q, k, v, o, bf16, grid, s, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
