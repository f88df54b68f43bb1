// row_tiles.cuh: tiles of quantized summary rows streamed into shared
// memory by the Tensor Memory Accelerator, and scored there, for the
// kernels that read whole contiguous ranges of [n, S] summary rows
// (summary_dot, router_hier).
//
// A tile is `rows` consecutive rows of one plane. Their coords (i32),
// levels (u8), scales and zeros (f32) are four contiguous byte ranges,
// each copied into its region of a ring stage by a one-dimensional bulk
// copy (cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes,
// no tensor map), or, under kBulkMin bytes, by 16-byte cp.async copies. A
// bulk copy needs 16-byte aligned addresses and sizes: the aligned
// interior of a range goes by one bulk copy, its ragged head and tail
// (under 16 bytes each) by the issuing thread, so no byte outside the
// range is read. A byte at global address g of a range that starts at a
// lands at offset g - (a & ~15) of its region. One lane of the producer
// warp issues a tile of one plane's rows; a tile of several short runs
// (router_hier's stage B) has a lane per run, so the runs' address
// arithmetic and copies go out in parallel.
//
// The ring has kTileStages stages. A stage's full barrier completes when
// the producer warp's 32 lanes have arrived (after their plain loads and
// their cp.async copies) and the bulk bytes that the issuing lanes
// announced have landed; its empty barrier when each of the
// kTileConsumers consumer warps has arrived. Producer and consumers walk
// the same sequence of tiles, so stage k % kTileStages with parity
// (k / kTileStages) & 1 names the k-th tile on both sides.
// This file is the one definition of the ring's layout and of the tile
// sizes; each kernel's C entry point sizes its launch from the shapes
// alone, and its library exports the sizes (summary_dot_geometry,
// router_hier_geometry) for the wrappers' shared-memory cap and for
// chip_smoke.py's report.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_dot.cuh"

namespace seismic {

constexpr int kTileConsumers = 8;                  // consumer warps
constexpr int kTileThreads = (kTileConsumers + 1) * 32;  // + the producer
constexpr int kTileStages = 3;
constexpr int kBarrierBytes = 128;       // the barriers, before the ring
constexpr int kStageTarget = 32 * 1024;  // a stage's bytes (two blocks an SM)
constexpr int kLongRow = 256;            // rows this long: one per warp

// a region that holds n bytes copied from any 16-byte phase
__host__ __device__ constexpr uint32_t region_bytes(uint32_t n) {
  return (n + 31u) & ~15u;
}

// Offsets of a stage's regions for `rows` rows of s entries (coords at 0).
struct StageLayout {
  uint32_t levels, scale, zero, bytes;
};

__host__ __device__ inline StageLayout stage_layout(int rows, int s) {
  const uint32_t n = (uint32_t)rows * (uint32_t)s;
  StageLayout l;
  l.levels = region_bytes(4u * n);
  l.scale = l.levels + region_bytes(n);
  l.zero = l.scale + region_bytes(4u * rows);
  l.bytes = l.zero + region_bytes(4u * rows);
  return l;
}

// The q bitmap: one bit per coordinate, in 32-bit words.
__host__ __device__ inline uint32_t bitmap_bytes(int d) {
  return 4u * (uint32_t)((d + 31) / 32);
}

// Rows a consumer warp scores at once: 4 short rows (3 entries per lane
// loaded ahead each) or 1 long one (8 entries per lane ahead).
__host__ __device__ constexpr int rows_per_warp(int s) {
  return s >= kLongRow ? 1 : 4;
}

// Rows per tile: the most whole groups of kTileConsumers * rows_per_warp
// rows whose stage fits kStageTarget; where one group does not fit, the
// most rows that do (at least one).
__host__ __device__ inline int tile_rows(int s) {
  const int group = kTileConsumers * rows_per_warp(s);
  // each region pads its bytes by 16 to 31, so the fit lies just below
  int fit = (kStageTarget - 64) / (5 * s + 8);
  if (fit < 1) fit = 1;
  while (fit > 1 && stage_layout(fit, s).bytes > (uint32_t)kStageTarget)
    --fit;
  return fit < group ? fit : fit / group * group;
}

// The first row of a tile in global memory.
struct Rows {
  const int32_t* c;
  const uint8_t* v;
  const float* scale;
  const float* zero;
};

// One row as the row dot reads it.
struct RowRef {
  const int32_t* c;
  const uint8_t* v;
  float scale, zero;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Thread 0 makes the ring's barriers; the caller then synchronises the
// block (or the cluster) before any thread uses them.
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kTileStages; ++st) {
      mbar_init(full + st, 32);
      mbar_init(empty + st, kTileConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// A range this long or longer moves its aligned interior by a bulk copy;
// a shorter one by the thread's 16-byte cp.async copies (the copy engine
// takes bulk copies one after another, and a short one costs it about as
// much as a long one: router_hier's stage-B runs of a few rows go faster
// by the lanes' own copies).
constexpr uint32_t kBulkMin = 256;

// bytes of [a, a + n) that go by a bulk copy: the 16-byte aligned
// interior of a range of at least kBulkMin bytes
__device__ __forceinline__ uint32_t bulk_part(uintptr_t a, uint32_t n) {
  const uintptr_t a16 = (a + 15) & ~uintptr_t(15);
  const uintptr_t b16 = (a + n) & ~uintptr_t(15);
  return n >= kBulkMin && a16 < b16 ? (uint32_t)(b16 - a16) : 0u;
}

template <int kBytes>
__device__ __forceinline__ void cp_async(unsigned char* dst, uintptr_t src) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
}

// [src, src + n) into the region at dst (see the top of this file), by
// the calling thread alone: the 16-byte aligned interior by one bulk copy
// (or 16-byte cp.async copies, under kBulkMin bytes), the whole words of
// the head and tail by 4-byte cp.async copies, and the bytes outside
// those words (at most 3 at each end, and only where a range of bytes
// does not start or end on a word) by plain loads. The full barrier
// tracks the cp.async copies (tile_issued), so a range of 4-byte elements
// never stalls the thread on a load.
__device__ __forceinline__ void copy_range(unsigned char* dst,
                                           const void* src, uint32_t n,
                                           uint64_t* bar) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src), b = a + n;
  const uintptr_t fa = a & ~uintptr_t(15);
  uintptr_t a16 = (a + 15) & ~uintptr_t(15), b16 = b & ~uintptr_t(15);
  if (a16 >= b16) a16 = b16 = b;     // no interior: all of it is head
  if (bulk_part(a, n))
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst + (a16 - fa))),
        "l"(a16), "r"((uint32_t)(b16 - a16)), "r"(smem_u32(bar))
        : "memory");
  else
    for (uintptr_t g = a16; g < b16; g += 16) cp_async<16>(dst + (g - fa), g);
  auto edge = [&](uintptr_t g, uintptr_t e) {     // the bytes [g, e)
    while (g < e) {
      if ((g & 3) == 0 && g + 4 <= e) {
        cp_async<4>(dst + (g - fa), g);
        g += 4;
      } else {
        dst[g - fa] = *reinterpret_cast<const unsigned char*>(g);
        ++g;
      }
    }
  };
  edge(a, a16);
  edge(b16, b);
}

// Every lane of the producer warp, once all of a tile's parts are
// issued: the full barrier waits for the lane's cp.async copies too, and
// the lane arrives (releasing its plain stores).
__device__ __forceinline__ void tile_issued(uint64_t* full) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(full))
               : "memory");
  mbar_arrive(full);
}

// The calling thread copies `rows` rows of s entries starting at g into
// the stage region `dst` laid out as l, first announcing their bulk bytes
// on `full`. A tile may be several such parts, each issued by its own
// lane of the producer warp; the warp's lanes then call
// tile_issued(full).
__device__ __forceinline__ void copy_rows(unsigned char* dst, StageLayout l,
                                          Rows g, int rows, int s,
                                          uint64_t* full) {
  const uint32_t n = (uint32_t)rows * (uint32_t)s;
  mbar_expect_tx(full,
                 bulk_part(reinterpret_cast<uintptr_t>(g.c), 4u * n) +
                     bulk_part(reinterpret_cast<uintptr_t>(g.v), n) +
                     bulk_part(reinterpret_cast<uintptr_t>(g.scale),
                               4u * rows) +
                     bulk_part(reinterpret_cast<uintptr_t>(g.zero),
                               4u * rows));
  copy_range(dst, g.c, 4u * n, full);
  copy_range(dst + l.levels, g.v, n, full);
  copy_range(dst + l.scale, g.scale, 4u * rows, full);
  copy_range(dst + l.zero, g.zero, 4u * rows, full);
}

// A tile copied from g into the region at src: its first row's coords,
// levels, scale and zero; row(i, s) is row i.
struct TileBase {
  const int32_t* c;
  const uint8_t* v;
  const float* scale;
  const float* zero;
  __device__ __forceinline__ RowRef row(int i, int s) const {
    return {c + (long long)i * s, v + (long long)i * s, scale[i], zero[i]};
  }
};

__device__ __forceinline__ TileBase tile_base(const unsigned char* src,
                                              StageLayout l, Rows g) {
  auto at = [&](uint32_t off, const void* p) {
    return src + off + (reinterpret_cast<uintptr_t>(p) & 15);
  };
  return {reinterpret_cast<const int32_t*>(at(0, g.c)),
          reinterpret_cast<const uint8_t*>(at(l.levels, g.v)),
          reinterpret_cast<const float*>(at(l.scale, g.scale)),
          reinterpret_cast<const float*>(at(l.zero, g.zero))};
}

// Row i of a tile copied from g into the region at src.
__device__ __forceinline__ RowRef tile_row(const unsigned char* src,
                                           StageLayout l, Rows g, int i,
                                           int s) {
  return tile_base(src, l, g).row(i, s);
}

// A consumer warp scores rows first .. first + R - 1, then step rows on,
// and so on below n (first = cw R, step = kTileConsumers R for the tile
// that all consumer warps share; 0 and R for rows a warp scores alone), R
// rows at once and K entries per lane ahead (row_dots, so each row keeps
// the one sum order); row_at(i) gives row i, store(i, s) is called by
// lane i % R. A group's rows past n repeat its first row and are not
// stored.
template <int R, int K, typename Q, typename RowAt, typename Store>
__device__ __forceinline__ void score_rows(const Q& qv, int n, int s,
                                           int first, int step, int lane,
                                           RowAt row_at, Store store) {
  for (int i0 = first; i0 < n; i0 += step) {
    const int32_t* c[R];
    const uint8_t* v[R];
    float sc[R], z[R], dot[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const RowRef x = row_at(i0 + r < n ? i0 + r : i0);
      c[r] = x.c;
      v[r] = x.v;
      sc[r] = x.scale;
      z[r] = x.zero;
    }
    row_dots<R, K, int32_t, uint8_t, true>(qv, c, v, s, sc, z, lane, dot);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (lane == r && i0 + r < n) store(i0 + r, dot[r]);
  }
}

}  // namespace seismic
