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
// u8 level) and buys 4 flops. At the flat router's shapes (Q = 256,
// L = cut * n_blocks = 4940, S = 96) the inputs are 121.4 M entries, about
// 0.63 GB with q, scale, zero and the output: at least 0.19 ms at
// 3.35 TB/s.
//
// Design. A warp per row that reads its entries and then looks q up at
// each of them from L2 is a chain of dependent round trips, and each
// lookup costs a 32-byte L2 sector for 4 bytes. Here one block of one
// producer warp and kTileConsumers consumer warps takes one query and a
// chunk of its L rows (geometry() below sizes the chunk so the block's
// rows outweigh its pass over q_dense's row at least tenfold: all L rows
// at the router's shapes). One query's rows are contiguous in
// [Q, L, S], so the producer streams tiles of them into a
// kTileStages-stage ring in shared memory by bulk copies (row_tiles.cuh),
// starting before the block marks its query's non-zeros in a
// shared-memory bitmap (one coalesced pass over q_dense's row, d / 8
// bytes). The consumers score R rows at once from shared memory with K
// entries per lane loaded ahead (R = 4, K = 3 for short rows, R = 1,
// K = 8 for long ones such as the 768-entry superblock rows), and look q up through the bitmap (QMasked): a
// coordinate the query lacks, most of them, contributes q_dense's +0.0
// without leaving the SM. The row dot is the shared one of row_dot.cuh
// (lane-strided sums, a warp-shuffle tree), so router_flat and
// router_hier score a summary row bitwise as this kernel does. The
// launch allocates nothing and runs on the caller's stream; the C entry
// point returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_dot.cuh"
#include "row_tiles.cuh"

namespace {

using seismic::kTileConsumers;
using seismic::kTileStages;
using seismic::kTileThreads;
using seismic::QMasked;
using seismic::Rows;
using seismic::StageLayout;

template <int R, int K>
__global__ void __launch_bounds__(kTileThreads, 2)
summary_dot_kernel(const float* __restrict__ q,
                   const int32_t* __restrict__ coords,
                   const uint8_t* __restrict__ levels,
                   const float* __restrict__ scale,
                   const float* __restrict__ zero, float* __restrict__ out,
                   int L, int S, int d, int tile_rows, int chunk_rows,
                   int n_chunks, uint32_t stage_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kTileStages;
  unsigned char* ring = smem + seismic::kBarrierBytes;
  uint32_t* bits =
      reinterpret_cast<uint32_t*>(ring + kTileStages * stage_bytes);
  const int qi = blockIdx.x / n_chunks;
  const int r0 = (blockIdx.x % n_chunks) * chunk_rows;
  const int n_rows = min(L - r0, chunk_rows);
  const int n_tiles = (n_rows + tile_rows - 1) / tile_rows;
  const long long row0 = (long long)qi * L + r0;   // the chunk's first row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const StageLayout lay = seismic::stage_layout(tile_rows, S);
  const float* qrow = q + (long long)qi * d;

  auto rows_of = [&](int t) -> Rows {
    const long long row = row0 + (long long)t * tile_rows;
    return {coords + row * S, levels + row * S, scale + row, zero + row};
  };
  auto size_of = [&](int t) {
    return min(tile_rows, n_rows - t * tile_rows);
  };
  auto issue = [&](int t) {           // the producer warp loads tile t
    const int st = t % kTileStages;
    if (t >= kTileStages)
      seismic::mbar_wait(empty + st, (t / kTileStages - 1) & 1);
    if (lane == 0)
      seismic::copy_rows(ring + st * stage_bytes, lay, rows_of(t),
                         size_of(t), S, full + st);
    seismic::tile_issued(full + st);
  };

  seismic::init_ring(full, empty);
  __syncthreads();
  if (warp == 0)      // the first tiles fly while the bitmap is made
    for (int t = 0; t < min(n_tiles, kTileStages); ++t) issue(t);
  seismic::mark_nonzeros(qrow, d, 0, (d + 31) / 32, warp, kTileConsumers + 1,
                         lane, [&](int w, uint32_t m) { bits[w] = m; });
  __syncthreads();

  if (warp == 0) {
    for (int t = kTileStages; t < n_tiles; ++t) issue(t);
    return;
  }
  const QMasked qv{qrow, bits};
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kTileStages;
    seismic::mbar_wait(full + st, (t / kTileStages) & 1);
    const unsigned char* src = ring + st * stage_bytes;
    const Rows g = rows_of(t);
    float* o = out + row0 + (long long)t * tile_rows;
    seismic::score_rows<R, K>(
        qv, size_of(t), S, (warp - 1) * R, kTileConsumers * R, lane,
        [&](int i) { return seismic::tile_row(src, lay, g, i, S); },
        [&](int i, float s) { o[i] = s; });
    __syncwarp();
    if (lane == 0) seismic::mbar_arrive(empty + st);
  }
}

// A block's summary bytes are at least this many times its pass over
// q_dense's row (d * 4 bytes), or the block takes all of its query's rows.
constexpr int kBitmapShare = 10;

struct Geometry {
  int rows_per_warp, tile_rows, chunk_rows;
  uint32_t stage_bytes, smem;
};

// Rows per warp, rows per tile, rows per block (whole tiles), a stage's
// bytes and the dynamic shared memory (barriers, ring, bitmap) for
// [Q, L, S] summaries at dimension d.
Geometry geometry(int L, int S, int d) {
  Geometry g;
  g.rows_per_warp = seismic::rows_per_warp(S);
  g.tile_rows = seismic::tile_rows(S);
  long long n_chunks =
      (long long)L * (5LL * S + 8) / ((long long)kBitmapShare * 4 * d);
  if (n_chunks < 1) n_chunks = 1;
  const long long chunk = (L + n_chunks - 1) / n_chunks;
  g.chunk_rows = (int)((chunk + g.tile_rows - 1) / g.tile_rows * g.tile_rows);
  g.stage_bytes = seismic::stage_layout(g.tile_rows, S).bytes;
  g.smem = seismic::kBarrierBytes + kTileStages * g.stage_bytes +
           seismic::bitmap_bytes(d);
  return g;
}

template <int R, int K>
int launch(const float* q, const int32_t* coords, const uint8_t* levels,
           const float* scale, const float* zero, float* out, int Q, int L,
           int S, int d, const Geometry& g, cudaStream_t stream) {
  const int n_chunks = (L + g.chunk_rows - 1) / g.chunk_rows;
  const cudaError_t e = cudaFuncSetAttribute(
      summary_dot_kernel<R, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)g.smem);
  if (e != cudaSuccess) return (int)e;
  summary_dot_kernel<R, K><<<(unsigned)((long long)Q * n_chunks),
                             kTileThreads, g.smem, stream>>>(
      q, coords, levels, scale, zero, out, L, S, d, g.tile_rows,
      g.chunk_rows, n_chunks, g.stage_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch geometry of [Q, L, S] summaries at dimension d, into out:
// rows per warp, rows per tile, rows per block, stage bytes, dynamic
// shared memory, ring stages.
extern "C" int summary_dot_geometry(int L, int S, int d, int* out) {
  if (L < 1 || S < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(L, S, d);
  const int v[] = {g.rows_per_warp, g.tile_rows, g.chunk_rows,
                   (int)g.stage_bytes, (int)g.smem, kTileStages};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

extern "C" int summary_dot_launch(const float* q, const int32_t* coords,
                                  const uint8_t* levels, const float* scale,
                                  const float* zero, float* out, int Q, int L,
                                  int S, int d, cudaStream_t stream) {
  if (Q < 1 || L < 1 || S < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(L, S, d);
  if (g.rows_per_warp == 4)
    return launch<4, 3>(q, coords, levels, scale, zero, out, Q, L, S, d, g,
                        stream);
  return launch<1, 8>(q, coords, levels, scale, zero, out, Q, L, S, d, g,
                      stream);
}
