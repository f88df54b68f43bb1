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
// Design. Every summary row is scored by one warp with the shared row
// dot of row_dot.cuh, so a row scores bitwise as the summary_dot kernel
// scores it on the unfused path: fuse levels 0 and 2 route identically,
// top-m choice included. The flat kernel, simple and right first, has
// one warp per output element and reads rows where they lie, through L2.
//
// The hierarchical kernel was a chain of dependent L2 round trips (one
// 256-thread block per query, each warp walking ~62 superblock rows of 24
// entries per lane, q looked up in L2 at every entry). It now runs one
// thread block cluster of C blocks per query, each block one producer
// warp and 8 consumer warps (row_tiles.cuh). The wrapper
// (row_tiles.cluster_size) takes the most blocks per query, up to 8,
// that still have an SM each: 1 at a server's batch of 256 queries,
// where the card is full and more blocks would only repeat the query's
// set-up and sort; 8 at an online server's batch of 8 on 132 SMs.
// * The blocks build the query's non-zero bitmap together, each marking
//   1/C of the words in every block's copy through distributed shared
//   memory, so q_dense's row is read once per query; a coordinate the
//   query lacks then costs no L2 read (QMasked).
// * Stage A: a probed list's superblock tier is contiguous in
//   [L, ns, S2], so it is cut into tiles of tile_a rows, each trimmed to
//   its live superblocks; the tiles with one are dealt to the blocks in
//   turn, streamed by bulk copies into a 3-stage ring and scored there,
//   and each score goes into every block's copy of the stage-A array
//   through distributed shared memory.
// * Top-m: each block sorts its own identical copy (a bitonic sort over
//   the scores padded to a power of two, padding at -inf with indices
//   past the real ones, by score descending, then index ascending; the
//   steps inside 64-entry chunks warp by warp), so every block picks the
//   same m with no further exchange.
// * Stage B: each block takes the top-m positions j = rank, rank + C, ...;
//   a superblock's children are one contiguous range of at most fanout
//   rows of [L, nb, S] (and of block_len). A tile holds segs_b of them,
//   a producer lane and a consumer warp per superblock.
// * The cluster synchronises before any block exits, so no write through
//   distributed shared memory targets a block that has gone.
// No launch allocates; each runs on the caller's stream and its C entry
// point returns cudaGetLastError().
#include <cooperative_groups.h>
#include <algorithm>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_dot.cuh"
#include "row_tiles.cuh"

namespace {

constexpr int kWarps = 8;              // router_flat: warps per block
constexpr int kThreads = kWarps * 32;

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

// Sorts the P = 2^n entries (u, ui) in shared memory into lax.top_k
// order (score descending, index ascending) by a bitonic sort over the
// block's warps. A step whose pairs lie within 64-entry chunks runs warp
// by warp, a chunk per warp (__syncwarp); only the steps with a stride of
// 64 or more need the whole block.
__device__ __forceinline__ void sort_top_k(float* u, int* ui, int P,
                                           int warp, int lane) {
  constexpr int kWarpsAll = seismic::kTileThreads / 32;
  auto step = [&](int i, int j, int k) {
    const int p = i ^ j;
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
  };
  for (int k = 2; k <= P; k <<= 1) {
    if (k > 64) __syncthreads();      // the warps' chunks are done
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 64) {
        for (int i = threadIdx.x; i < P; i += seismic::kTileThreads)
          if ((i & j) == 0) step(i, j, k);
        __syncthreads();
      } else {
        // lane -> the pair (i, i + j) of its warp's chunk, i's bit j clear
        const int off = ((lane & ~(j - 1)) << 1) | (lane & (j - 1));
        for (int c0 = warp * 64; c0 < P; c0 += kWarpsAll * 64)
          if (c0 + off < P) step(c0 + off, j, k);
        __syncwarp();
      }
    }
  }
  __syncthreads();
}

// The two-stage route, one cluster of C blocks per query (the wrapper
// chooses C, hier_geometry() the tiles). Stage A's superblock rows are scored with RA rows per
// warp and KA entries per lane ahead, stage B's child rows with RB and KB.
template <int RA, int KA, int RB, int KB>
__global__ void __launch_bounds__(seismic::kTileThreads, 2)
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
                   int fanout, int P, int per_c, int d, int tile_a,
                   int segs_b, uint32_t stage_bytes) {
  using seismic::kTileStages;
  using seismic::kTileThreads;
  using seismic::Rows;
  using seismic::StageLayout;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const long long qi = blockIdx.x / C;
  const int nw = (d + 31) / 32, n_sup = cut * ns;
  const int per_tiles = (ns + tile_a - 1) / tile_a;  // stage-A tiles a list
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kTileStages;
  unsigned char* ring = smem + seismic::kBarrierBytes;
  uint32_t* bits =
      reinterpret_cast<uint32_t*>(ring + kTileStages * stage_bytes);
  float* u = reinterpret_cast<float*>(bits + nw);   // [P] stage-A scores
  int* ui = reinterpret_cast<int*>(u + P);          // [P] their indices
  // [per_c] this block's stage-A tiles, then its stage-B superblocks
  int* mine = ui + P;
  int* lst = mine + per_c;            // [cut] the probed lists, clipped
  unsigned char* alive =                            // [n_sup]
      reinterpret_cast<unsigned char*>(lst + cut);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qrow = q + qi * d;
  const StageLayout lay_a = seismic::stage_layout(tile_a, S2);
  const StageLayout lay_b = seismic::stage_layout(fanout, S);
  // a stage-B segment: a superblock's child rows, then their block_len
  const uint32_t seg_bytes = lay_b.bytes + seismic::region_bytes(4u * fanout);

  // ---- set-up: the ring, the sort's padding, the probed lists, which
  // superblocks are alive (any child block live)
  seismic::init_ring(full, empty);
  for (int i = n_sup + threadIdx.x; i < P; i += kTileThreads) {
    u[i] = -INFINITY;
    ui[i] = i;
  }
  for (int c = threadIdx.x; c < cut; c += kTileThreads)
    lst[c] = (int)clip_list(lists[qi * cut + c], L);
  __syncthreads();
  for (int i = threadIdx.x; i < n_sup; i += kTileThreads) {
    const long long row = (long long)lst[i / ns] * nb;
    const int g = i % ns, c1 = min(g * fanout + fanout, nb);
    bool any = false;
    for (int c = g * fanout; c < c1; ++c) any |= block_len[row + c] > 0;
    alive[i] = any;
  }
  __syncthreads();
  // stage-A tile t: rows [t0, t1) of probe slot t / per_tiles, trimmed to
  // its first and last live superblock (a list's dead tail is not read).
  // The tiles with a live superblock are dealt to the cluster's blocks in
  // turn, so the blocks get equal shares whatever the lists' lengths;
  // warp 0 lists this block's, every warp counts them.
  auto tile_rows_of = [&](int t, int* t1) {
    const int c = t / per_tiles;
    int t0 = c * ns + (t % per_tiles) * tile_a;
    *t1 = min(t0 + tile_a, (c + 1) * ns);
    while (t0 < *t1 && !alive[t0]) ++t0;
    while (*t1 > t0 && !alive[*t1 - 1]) --*t1;
    return t0;
  };
  int n_a = 0, n_live = 0;
  for (int t0 = 0; t0 < cut * per_tiles; t0 += 32) {
    const int t = t0 + lane;
    int r1 = 0;
    const bool live = t < cut * per_tiles && tile_rows_of(t, &r1) < r1;
    const uint32_t b = __ballot_sync(0xffffffffu, live);
    const int ord = n_live + __popc(b & ((1u << lane) - 1));
    const bool take = live && ord % C == rank;
    const uint32_t tb = __ballot_sync(0xffffffffu, take);
    if (take && warp == 0) mine[n_a + __popc(tb & ((1u << lane) - 1))] = t;
    n_live += __popc(b);
    n_a += __popc(tb);
  }
  cluster.sync();         // every block runs: shared memory may be written

  // a ring slot per tile, counted alike by the producer and the consumers
  auto slot = [&](int k) { return ring + (k % kTileStages) * stage_bytes; };
  auto acquire = [&](int k) {
    if (k >= kTileStages)
      seismic::mbar_wait(empty + k % kTileStages, (k / kTileStages - 1) & 1);
  };
  auto release = [&](int k) {
    __syncwarp();
    if (lane == 0) seismic::mbar_arrive(empty + k % kTileStages);
  };
  auto sup_rows = [&](int i) -> Rows {
    const long long row = (long long)lst[i / ns] * ns + i % ns;
    return {sup_coords + row * S2, sup_q + row * S2, sup_scale + row,
            sup_zero + row};
  };
  auto load_a = [&](int k) {          // this block's k-th stage-A tile
    acquire(k);
    int r1;
    const int r0 = tile_rows_of(mine[k], &r1);
    if (lane == 0)
      seismic::copy_rows(slot(k), lay_a, sup_rows(r0), r1 - r0, S2,
                         full + k % kTileStages);
    seismic::tile_issued(full + k % kTileStages);
  };
  // stage-A score i into every block's copy of (u, ui)
  auto put_a = [&](int i, float s) {
    for (int r = 0; r < C; ++r) {
      cluster.map_shared_rank(u, r)[i] = s;
      cluster.map_shared_rank(ui, r)[i] = i;
    }
  };

  // ---- the bitmap, built together: this block marks 1/C of the words
  // in every block's copy; the dead superblocks i = rank mod C go out as
  // -inf meanwhile
  int k = 0;
  if (warp == 0)                  // the first tiles fly meanwhile
    for (; k < min(n_a, kTileStages); ++k) load_a(k);
  const int per_w = (nw + C - 1) / C;
  const int w0 = min(nw, rank * per_w), w1 = min(nw, w0 + per_w);
  seismic::mark_nonzeros(
      qrow, d, w0, w1, warp, seismic::kTileConsumers + 1, lane,
      [&](int w, uint32_t mask) {
        for (int r = 0; r < C; ++r) cluster.map_shared_rank(bits, r)[w] = mask;
      });
  for (int i = rank + C * threadIdx.x; i < n_sup; i += C * kTileThreads)
    if (!alive[i]) put_a(i, -INFINITY);
  cluster.sync();

  // ---- stage A: the block's tiles, streamed and scored
  const seismic::QMasked qv{qrow, bits};
  if (warp == 0) {
    for (; k < n_a; ++k) load_a(k);
  } else {
    for (; k < n_a; ++k) {
      seismic::mbar_wait(full + k % kTileStages, (k / kTileStages) & 1);
      const unsigned char* src = slot(k);
      int r1;
      const int r0 = tile_rows_of(mine[k], &r1);
      const Rows g = sup_rows(r0);
      seismic::score_rows<RA, KA>(
          qv, r1 - r0, S2, (warp - 1) * RA, seismic::kTileConsumers * RA,
          lane,
          [&](int r) { return seismic::tile_row(src, lay_a, g, r, S2); },
          [&](int r, float s) {
            if (alive[r0 + r]) put_a(r0 + r, s);
          });
      release(k);
    }
  }
  cluster.sync();               // every block holds all n_sup scores

  // ---- top-m: each block sorts its own identical copy into lax.top_k
  // order
  sort_top_k(u, ui, P, warp, lane);

  // ---- stage B: this block's share of the top m (j = rank, rank + C,
  // ...). Children out of range or under a superblock that is not finite
  // are -inf without a read; the scored superblocks' children, one
  // contiguous range of at most fanout rows each, go through the ring,
  // segs_b superblocks a tile.
  const int n_out = m * fanout;
  for (int t = threadIdx.x; t < n_out; t += kTileThreads) {
    const int j = t / fanout;
    if (j % C != rank) continue;
    const int sid = ui[j];
    const int child = (sid % ns) * fanout + t % fanout;
    flat[qi * n_out + t] = (sid / ns) * nb + min(child, nb - 1);
    if (child >= nb || !isfinite(u[j])) rb[qi * n_out + t] = -INFINITY;
  }
  int n_mine = 0;               // every warp makes the same list
  for (int x0 = 0; rank + C * x0 < m; x0 += 32) {
    const int j = rank + C * (x0 + lane);
    const bool scored = j < m && isfinite(u[j]);
    const uint32_t b = __ballot_sync(0xffffffffu, scored);
    if (scored && warp == 0) mine[n_mine + __popc(b & ((1u << lane) - 1))] = j;
    n_mine += __popc(b);
  }
  __syncthreads();
  struct Seg {
    long long row;              // the first child's row of the sum planes
    int n, j;                   // children in range; the top-m position
  };
  auto seg = [&](int x) -> Seg {
    const int j = mine[x], sid = ui[j], c0 = (sid % ns) * fanout;
    return {(long long)lst[sid / ns] * nb + c0, min(fanout, nb - c0), j};
  };
  auto sum_rows = [&](long long row) -> Rows {
    return {sum_coords + row * S, sum_q + row * S, sum_scale + row,
            sum_zero + row};
  };
  const int n_tiles_b = (n_mine + segs_b - 1) / segs_b;
  if (warp == 0) {
    for (int tb = 0; tb < n_tiles_b; ++tb, ++k) {
      acquire(k);
      const int x0 = tb * segs_b, x1 = min(n_mine, x0 + segs_b);
      for (int x = x0 + lane; x < x1; x += 32) {    // a lane a superblock
        const Seg sg = seg(x);
        unsigned char* dst = slot(k) + (x - x0) * seg_bytes;
        uint64_t* bar = full + k % kTileStages;
        seismic::copy_rows(dst, lay_b, sum_rows(sg.row), sg.n, S, bar);
        seismic::mbar_expect_tx(
            bar, seismic::bulk_part(
                     reinterpret_cast<uintptr_t>(block_len + sg.row),
                     4u * sg.n));
        seismic::copy_range(dst + lay_b.bytes, block_len + sg.row, 4u * sg.n,
                            bar);
      }
      seismic::tile_issued(full + k % kTileStages);
    }
  } else {
    for (int tb = 0; tb < n_tiles_b; ++tb) {
      const int x0 = tb * segs_b, x1 = min(n_mine, x0 + segs_b);
      seismic::mbar_wait(full + k % kTileStages, (k / kTileStages) & 1);
      // a warp per superblock: its children, at most fanout rows
      for (int x = x0 + warp - 1; x < x1; x += seismic::kTileConsumers) {
        const Seg sg = seg(x);
        const unsigned char* src = slot(k) + (x - x0) * seg_bytes;
        const Rows g = sum_rows(sg.row);
        const int32_t* bl = reinterpret_cast<const int32_t*>(
            src + lay_b.bytes +
            (reinterpret_cast<uintptr_t>(block_len + sg.row) & 15));
        float* o = rb + qi * n_out + sg.j * fanout;
        seismic::score_rows<RB, KB>(
            qv, sg.n, S, 0, RB, lane,
            [&](int r) { return seismic::tile_row(src, lay_b, g, r, S); },
            [&](int r, float s) { o[r] = bl[r] > 0 ? s : -INFINITY; });
      }
      release(k++);
    }
  }
  cluster.sync();        // no block exits while another may write to it
}

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

struct HierGeometry {
  int rows_per_warp_a, rows_per_warp_b, tile_a, segs_b, P, per_c;
  uint32_t stage_bytes, smem;
};

// router_hier's launch geometry for clusters of `cluster` blocks per
// query: stage-A tiles of superblock rows (tile_rows(S2), at most that
// many rows of one probed list); stage-B tiles of segs_b superblocks'
// children (fanout rows of S each, then their block_len); one stage that
// holds either; dynamic shared memory for the barriers, the ring, the q
// bitmap, the P = next_pow2(cut * ns) sorted scores and indices, a
// block's share of the stage-A tiles or of the top m (an index each),
// the probed lists (an index each) and a liveness flag per superblock.
HierGeometry hier_geometry(int cut, int ns, int S2, int S, int fanout, int m,
                           int d, int cluster) {
  using seismic::stage_layout;
  HierGeometry g;
  const int n_sup = cut * ns;
  const uint32_t seg =
      stage_layout(fanout, S).bytes + seismic::region_bytes(4u * fanout);
  g.rows_per_warp_a = seismic::rows_per_warp(S2);
  g.rows_per_warp_b = seismic::rows_per_warp(S);
  g.tile_a = seismic::tile_rows(S2);
  g.segs_b = std::max(1, (int)(seismic::kStageTarget / seg));
  g.P = next_pow2(n_sup);
  g.stage_bytes =
      std::max(stage_layout(g.tile_a, S2).bytes, (uint32_t)g.segs_b * seg);
  g.per_c =
      (std::max(cut * ((ns + g.tile_a - 1) / g.tile_a), m) + cluster - 1) /
      cluster;
  g.smem = seismic::kBarrierBytes + seismic::kTileStages * g.stage_bytes +
           seismic::bitmap_bytes(d) + 8u * g.P + 4u * (g.per_c + cut) +
           n_sup;
  return g;
}

template <int RA, int KA, int RB, int KB>
int launch_hier(const int32_t* lists, const float* q,
                const int32_t* sup_coords, const uint8_t* sup_q,
                const float* sup_scale, const float* sup_zero,
                const int32_t* sum_coords, const uint8_t* sum_q,
                const float* sum_scale, const float* sum_zero,
                const int32_t* block_len, float* rb, int32_t* flat, int Q,
                int cut, int L, int ns, int S2, int nb, int S, int m,
                int fanout, int d, int cluster, const HierGeometry& g,
                cudaStream_t stream) {
  auto kernel = router_hier_kernel<RA, KA, RB, KB>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)Q * (unsigned)cluster);
  cfg.blockDim = dim3(seismic::kTileThreads);
  cfg.dynamicSmemBytes = (size_t)g.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, lists, q, sup_coords, sup_q,
                         sup_scale, sup_zero, sum_coords, sum_q, sum_scale,
                         sum_zero, block_len, rb, flat, cut, L, ns, S2, nb,
                         S, m, fanout, g.P, g.per_c, d, g.tile_a, g.segs_b,
                         g.stage_bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool hier_shapes_ok(int cut, int ns, int S2, int S, int fanout, int m,
                    int d, int cluster) {
  return cut >= 1 && ns >= 1 && S2 >= 1 && S >= 1 && m >= 1 &&
         m <= cut * ns && fanout >= 1 && d >= 1 && cluster >= 1 &&
         cluster <= 8;
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

// router_hier's launch geometry (hier_geometry) into out: cluster,
// rows per warp in stage A and in stage B, stage-A tile rows, stage-B
// superblocks a tile, stage bytes, dynamic shared memory, ring stages.
extern "C" int router_hier_geometry(int cut, int ns, int S2, int S,
                                    int fanout, int m, int d, int cluster,
                                    int* out) {
  if (!hier_shapes_ok(cut, ns, S2, S, fanout, m, d, cluster))
    return (int)cudaErrorInvalidValue;
  const HierGeometry g =
      hier_geometry(cut, ns, S2, S, fanout, m, d, cluster);
  const int v[] = {cluster,        g.rows_per_warp_a, g.rows_per_warp_b,
                   g.tile_a,       g.segs_b,          (int)g.stage_bytes,
                   (int)g.smem,    seismic::kTileStages};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

extern "C" int router_hier_launch(
    const int32_t* lists, const float* q, const int32_t* sup_coords,
    const uint8_t* sup_q, const float* sup_scale, const float* sup_zero,
    const int32_t* sum_coords, const uint8_t* sum_q, const float* sum_scale,
    const float* sum_zero, const int32_t* block_len, float* rb,
    int32_t* flat, int Q, int cut, int L, int ns, int S2, int nb, int S,
    int m, int fanout, int d, int cluster, cudaStream_t stream) {
  if (Q < 1 || !hier_shapes_ok(cut, ns, S2, S, fanout, m, d, cluster))
    return (int)cudaErrorInvalidValue;
  const HierGeometry g =
      hier_geometry(cut, ns, S2, S, fanout, m, d, cluster);
#define ROUTER_HIER_LAUNCH(RA, KA, RB, KB)                                   \
  return launch_hier<RA, KA, RB, KB>(                                        \
      lists, q, sup_coords, sup_q, sup_scale, sup_zero, sum_coords, sum_q,   \
      sum_scale, sum_zero, block_len, rb, flat, Q, cut, L, ns, S2, nb, S, m, \
      fanout, d, cluster, g, stream)
  // rows per warp 4 go with 3 entries per lane ahead, 1 with 8
  const int ra = g.rows_per_warp_a, rb_ = g.rows_per_warp_b;
  if (ra == 1 && rb_ == 4) ROUTER_HIER_LAUNCH(1, 8, 4, 3);
  if (ra == 4 && rb_ == 4) ROUTER_HIER_LAUNCH(4, 3, 4, 3);
  if (ra == 1 && rb_ == 1) ROUTER_HIER_LAUNCH(1, 8, 1, 8);
  ROUTER_HIER_LAUNCH(4, 3, 1, 8);
#undef ROUTER_HIER_LAUNCH
}
