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
// Design. Every summary row is scored by one warp in the order of the
// shared row dot of row_dot.cuh (lane-strided sums, then warp_sum's
// butterfly; the flat kernel's transpose_sum forms the same sums for
// several rows and queries at once), so a row scores bitwise as the
// summary_dot kernel scores it on the unfused path: fuse levels 0 and 2
// route identically, top-m choice included.
//
// The flat kernel is list-major. Its first design, one warp per output
// element reading its row where it lies and q through L2 at every entry,
// was a chain of dependent round trips that re-read a list's tier for
// every query probing it (15 % of its bound). A list's [nb, S] tier is
// contiguous in [L, nb, S], and a batch probes each distinct list many
// times (each live row 2.3 times at 256 queries, 15.5 times at 4096), so
// here each distinct probed list's live rows cross HBM once per group of
// up to kFlatGroup probing (query, slot) pairs, not once per pair: the
// lists are inverted into groups on the card, and a persistent block per
// SM slot streams a group's list through a bulk-copy ring (row_tiles.cuh)
// and scores every row for all the group's queries at once against a
// table in shared memory (the union of their non-zeros, with each
// query's value there), so one lookup per entry serves the group and a
// coordinate no query of the group has costs no L2 read. The groups of
// one list are taken one after another from a shared counter, so their
// blocks read the list's rows at about the same time and all but the
// first find them in L2. Dead blocks are -inf; the rows past a list's
// last live block are never read (live blocks form a prefix of each list
// in the builder's index; a dead block inside the prefix is read and
// written as -inf). Out-of-range probes are clipped and repeated probes
// scored as the plain version does: each pair has its own output row.
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

// a probed coordinate clipped into [0, L), as the TPU kernel's
// mode="clip" gather does
__device__ __forceinline__ long long clip_list(int v, int L) {
  return v < 0 ? 0 : (v >= L ? L - 1 : v);
}

// ---- router_flat, list-major
//
// A pair is one (query, probe slot) entry p = q * cut + slot of lists.
// router_flat_groups_kernel (one block) inverts lists: it counts the
// pairs of each probed list in shared memory, scans the counts, cuts each
// list's pairs into groups of at most kFlatGroup (sorted by list, so the
// groups of one list are neighbours) and writes every pair's position in
// the sorted order. router_flat_records_kernel writes each query's
// record: its non-zeros as a list of coordinates and values (at most
// kFlatNnz) and their count. router_flat_kernel runs one block per SM
// slot; each block takes groups from a shared counter. Per group the
// producer warp bulk-copies the group's records (two buffers: the next
// group's land while this one is scored) and streams the list's live
// block rows (the prefix up to its last live block) tile by tile through
// the ring, and meanwhile reads the next group's table entry, live rows
// and pairs; the consumer warps first merge the group's queries into one
// table (the union of their non-zeros as a bitmap, each bitmap word's
// rank, and a row of kFlatGroup values per union coordinate: q_dense of
// each query there, +0.0 where it has none), then score every row of a
// tile for all the group's queries at once: one lookup per entry serves
// the whole group, and the group's sums leave the warp by one transposed
// reduction (transpose_sum). A group whose union exceeds kFlatUnion
// coordinates, or that holds a query of more than kFlatNnz non-zeros, is
// scored query by query, q looked up in L2 (QRow).

constexpr int kFlatGroup = 8;          // pairs a group holds
constexpr int kFlatUnion = 512;        // union coordinates a table holds
constexpr int kFlatNnz = 128;          // non-zeros a query's record lists
constexpr int kFlatGroupsThreads = 1024;
constexpr int kFlatUnroll = 8;         // pairs a thread loads at once
constexpr int kConsumerThreads = seismic::kTileConsumers * 32;

// A query's record, in scratch and (bulk-copied) in shared memory: up to
// kFlatNnz non-zeros as coordinates, then their values, then the count of
// all its non-zeros. Offsets in bytes; bytes is a multiple of 16.
struct FlatRecord {
  static constexpr uint32_t coords = 0, vals = 4u * kFlatNnz,
                            nnz = 8u * kFlatNnz, bytes = nnz + 16u;
};

struct FlatScratch {   // offsets (in 32-bit words) into the wrapper's scratch
  long long records, ctrl, rank, sorted, groups, words;
};

// [Q] records first (16-byte aligned), then n_groups and the next-group
// counter, each pair's rank within its list, the pairs sorted by list and
// the group table (list, first sorted position, pairs).
__host__ __device__ inline FlatScratch flat_scratch(int Q, int cut,
                                                    int L) {
  const long long P = (long long)Q * cut;
  const long long groups_max = P / kFlatGroup + 1 + (P < L ? P : L);
  FlatScratch f;
  f.records = 0;
  f.ctrl = (long long)Q * (FlatRecord::bytes / 4);
  f.rank = f.ctrl + 4;
  f.sorted = f.rank + P;
  f.groups = f.sorted + P;
  f.words = f.groups + 3 * groups_max;
  return f;
}

// bitmap words per query: ceil(d / 32), padded to whole 16-byte copies
__host__ __device__ inline int flat_bitmap_words(int d) {
  return ((d + 31) / 32 + 3) & ~3;
}

// The group table in shared memory: the union's bitmap, each word's rank
// (set bits before it), the values [kFlatUnion][kFlatGroup] (16-byte
// aligned rows of 8 floats), and the scan's scratch. Offsets in bytes.
struct FlatUnion {
  uint32_t rank, vals, scratch, bytes;
};

__host__ __device__ inline FlatUnion flat_union(int nwp) {
  FlatUnion u;
  u.rank = 4u * (uint32_t)nwp;
  u.vals = u.rank + ((2u * (uint32_t)nwp + 15u) & ~15u);
  u.scratch = u.vals + 4u * kFlatUnion * kFlatGroup;
  u.bytes = u.scratch + 64u;
  return u;
}

// An exclusive scan of one int per thread over kW warps (the calling
// threads, 32 * kW of them, all reach it); scratch holds kW ints and
// sync() synchronises those threads. Returns the thread's prefix and sets
// *total to the sum.
template <int kW, typename Sync>
__device__ __forceinline__ int block_scan(int v, int* scratch, int* total,
                                          int t, Sync sync) {
  const int lane = t & 31, warp = t >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  sync();
  if (warp == 0) {
    int a = lane < kW ? scratch[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, a, o);
      if (lane >= o) a += y;
    }
    if (lane < kW) scratch[lane] = a;
  }
  sync();
  *total = scratch[kW - 1];
  const int before = x - v + (warp ? scratch[warp - 1] : 0);
  sync();                           // scratch may be reused after this
  return before;
}

// The consumer warps' own barrier (named barrier 1; the producer warp
// never waits on it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

__global__ void __launch_bounds__(kFlatGroupsThreads)
router_flat_groups_kernel(const int32_t* __restrict__ lists,
                          int32_t* __restrict__ ctrl,
                          int32_t* __restrict__ rank,
                          int32_t* __restrict__ sorted,
                          int32_t* __restrict__ groups, int P, int L) {
  constexpr int kT = kFlatGroupsThreads, kU = kFlatUnroll;
  extern __shared__ int cnt[];              // [L], then the scans' [32]
  int* scan = cnt + L;
  const int t = threadIdx.x;
  auto sync = [] { __syncthreads(); };
  // the records kernel, launched next, may start now: it does not read
  // what this kernel writes, and waits for it before it ends
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (int l = t; l < L; l += kT) cnt[l] = 0;
  __syncthreads();
  // kU pairs a thread at once, so their loads are in flight together
  for (int p0 = t; p0 < P; p0 += kU * kT) {
    int l[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      l[u] = p0 + u * kT < P ? (int)clip_list(lists[p0 + u * kT], L) : -1;
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (l[u] >= 0) rank[p0 + u * kT] = atomicAdd(&cnt[l[u]], 1);
  }
  __syncthreads();
  // each thread a run of consecutive lists: its pairs and groups, then an
  // exclusive scan of both over the block
  const int chunk = (L + kT - 1) / kT;
  const int l0 = min(L, t * chunk), l1 = min(L, l0 + chunk);
  int sp = 0, sg = 0;
  for (int l = l0; l < l1; ++l) {
    sp += cnt[l];
    sg += (cnt[l] + kFlatGroup - 1) / kFlatGroup;
  }
  int n_pairs, n_groups;
  int op = block_scan<kT / 32>(sp, scan, &n_pairs, t, sync);
  int og = block_scan<kT / 32>(sg, scan, &n_groups, t, sync);
  if (t == 0) {
    ctrl[0] = n_groups;
    ctrl[1] = 0;                            // the next group to take
  }
  for (int l = l0; l < l1; ++l) {
    const int c = cnt[l];
    for (int j = 0; j * kFlatGroup < c; ++j, ++og) {
      groups[3 * og] = l;
      groups[3 * og + 1] = op + j * kFlatGroup;
      groups[3 * og + 2] = min(kFlatGroup, c - j * kFlatGroup);
    }
    cnt[l] = op;                            // the list's first position
    op += c;
  }
  __syncthreads();
  for (int p0 = t; p0 < P; p0 += kU * kT) {
    int l[kU], r[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const bool in = p0 + u * kT < P;
      l[u] = in ? (int)clip_list(lists[p0 + u * kT], L) : -1;
      r[u] = in ? rank[p0 + u * kT] : 0;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (l[u] >= 0) sorted[cnt[l[u]] + r[u]] = p0 + u * kT;
  }
}

// One block per query: its record. Shared memory: the query's non-zero
// bitmap, then the scan's scratch.
__global__ void __launch_bounds__(kConsumerThreads)
router_flat_records_kernel(const float* __restrict__ q,
                          unsigned char* __restrict__ records, int d,
                          int nwp) {
  extern __shared__ uint32_t words[];
  int* scan = reinterpret_cast<int*>(words + nwp);
  using rl = FlatRecord;
  const long long qi = blockIdx.x;
  const float* qrow = q + qi * d;
  unsigned char* rec = records + qi * rl::bytes;
  const int t = threadIdx.x;
  seismic::mark_nonzeros(qrow, d, 0, nwp, t >> 5, seismic::kTileConsumers,
                         t & 31, [&](int w, uint32_t m) { words[w] = m; });
  __syncthreads();
  const int chunk = (nwp + kConsumerThreads - 1) / kConsumerThreads;
  const int w0 = min(nwp, t * chunk), w1 = min(nwp, w0 + chunk);
  int mine = 0;
  for (int w = w0; w < w1; ++w) mine += __popc(words[w]);
  int nnz;
  int off = block_scan<seismic::kTileConsumers>(
      mine, scan, &nnz, t, [] { __syncthreads(); });
  int32_t* coords = reinterpret_cast<int32_t*>(rec + rl::coords);
  float* vals = reinterpret_cast<float*>(rec + rl::vals);
  for (int w = w0; w < w1 && off < kFlatNnz; ++w)
    for (uint32_t m = words[w]; m && off < kFlatNnz; m &= m - 1, ++off) {
      const int c = w * 32 + __ffs(m) - 1;
      coords[off] = c;
      vals[off] = qrow[c];
    }
  if (t == 0) *reinterpret_cast<int*>(rec + rl::nnz) = nnz;
  // the groups kernel, which ran beside this one, is done and its writes
  // are visible before this kernel completes: the route, launched after
  // it, reads both
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// What the producer tells the consumers about a group.
struct FlatDesc {
  int list, n_live, n;        // n < 0: no group left
  int pair[kFlatGroup];
};

struct FlatGeometry {
  int rows_per_warp, tile_rows, grid, nwp;
  uint32_t stage_bytes, record_stride, union_bytes, smem, groups_smem,
      records_smem;
  FlatScratch scratch;
};

// One exchange of transpose_sum: V of the N values still held, the
// partner O lanes apart (the indices stay compile-time constants).
template <int N, int V, int O>
__device__ __forceinline__ void transpose_step(float (&a)[N], int lane) {
  if constexpr (O > 0) {
    if constexpr (V > 1) {
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        const float send = up ? a[i] : a[i + V / 2];
        const float keep = up ? a[i + V / 2] : a[i];
        a[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      transpose_step<N, V / 2, O / 2>(a, lane);
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], O);
      transpose_step<N, 1, O / 2>(a, lane);
    }
  }
}

// The sums of V (a power of two, at most 32) values across the warp,
// each the one warp_sum gives it: the exchanges with the lanes 16, 8, ...
// apart each hand half of the values to the partner and add the
// partner's half, so every partial sum is the one warp_sum forms (the
// same two operands), and the remaining steps add in place. Lane l ends
// with value transpose_lane<V>(l).
template <int V>
__device__ __forceinline__ float transpose_sum(float (&a)[V], int lane) {
  transpose_step<V, V, 16>(a, lane);
  return a[0];
}

template <int V>
__device__ __forceinline__ int transpose_lane(int lane) {
  constexpr int kShift = V >= 32 ? 0 : V >= 16 ? 1 : V >= 8 ? 2
                         : V >= 4 ? 3 : V >= 2 ? 4 : 5;
  return (lane >> kShift) & (V - 1);
}

// R rows of a tile against the group table: each lane loads K entries of
// the R rows at a time (row_dots' batches), looks each up in the union
// once and, at a hit, adds the kFlatGroup values times the entry, so
// every (query, row) sum takes its entries in row_dots' order (a miss of
// row_dots adds q_dense's +0.0 times the entry, which changes no sum that
// starts at +0.0). Returns the lane's value of transpose_sum: query
// m / R, row m % R, m = transpose_lane<kFlatGroup * R>.
template <int R, int K>
__device__ __forceinline__ float group_row_dots(
    const uint32_t* ubits, const uint16_t* urank, const float* uvals,
    const seismic::RowRef (&row)[R], int s, int lane) {
  float acc[kFlatGroup * R];
#pragma unroll
  for (int i = 0; i < kFlatGroup * R; ++i) acc[i] = 0.0f;
  for (int j0 = lane; j0 < s; j0 += 32 * K) {
    int col[K][R];
    float x[K][R];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + 32 * k;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        col[k][r] = 0;
        x[k][r] = 0.0f;
        if (j < s) {
          col[k][r] = row[r].c[j];
          const unsigned lv = row[r].v[j];
          x[k][r] = lv ? (float(lv) - 1.0f) * row[r].scale + row[r].zero
                       : 0.0f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = col[k][r];
        const uint32_t w = ubits[c >> 5], b = c & 31;
        if (j0 + 32 * k < s && ((w >> b) & 1u)) {
          const float* t =
              uvals + kFlatGroup * (urank[c >> 5] +
                                    __popc(w & ((1u << b) - 1u)));
          float v[kFlatGroup];
#pragma unroll
          for (int h = 0; h < kFlatGroup; h += 4) {
            const float4 f = *reinterpret_cast<const float4*>(t + h);
            v[h] = f.x;
            v[h + 1] = f.y;
            v[h + 2] = f.z;
            v[h + 3] = f.w;
          }
#pragma unroll
          for (int g = 0; g < kFlatGroup; ++g)
            acc[g * R + r] += v[g] * x[k][r];
        }
      }
  }
  return transpose_sum<kFlatGroup * R>(acc, lane);
}

// One tile's rows [0, rows) for the group's n queries, RU rows a warp at
// once (R / RU passes of the consumer warps): each (query, row) score
// goes to out at the query's pair, row0 + the row, -inf where the block
// is dead.
template <int R, int RU, int K>
__device__ __forceinline__ void score_tile(
    const uint32_t* ubits, const uint16_t* urank, const float* uvals,
    const seismic::TileBase& tb, const int32_t* bl, int rows, int s,
    const int* pairs, int n, float* __restrict__ out, int nb,
    long long row0, int warp, int lane) {
  constexpr int V = kFlatGroup * RU;
  const int m = transpose_lane<V>(lane);
  const int gq = m / RU, gr = m % RU;
  const bool mine = (lane & (32 / V - 1)) == 0 && gq < n;
  const long long o = mine ? (long long)pairs[gq] * nb + row0 : 0;
#pragma unroll
  for (int pass = 0; pass < R / RU; ++pass) {
    const int i0 = ((warp - 1) + pass * seismic::kTileConsumers) * RU;
    if (i0 < rows) {
      seismic::RowRef rr[RU];
#pragma unroll
      for (int r = 0; r < RU; ++r)
        rr[r] = tb.row(i0 + r < rows ? i0 + r : i0, s);
      const float v = group_row_dots<RU, K>(ubits, urank, uvals, rr, s,
                                            lane);
      const int i = i0 + gr;
      if (mine && i < rows) out[o + i] = bl[i] > 0 ? v : -INFINITY;
    }
  }
}

// Builds the group table from the n records at recs (stride bytes
// apart): the union of their listed coordinates as a bitmap and its
// ranks, then the values (q_dense of query g at each of its non-zeros;
// the rest +0.0). Returns false, the table unfilled, where a query's
// non-zeros exceed its list or the union exceeds kFlatUnion. All consumer
// threads call it.
__device__ __forceinline__ bool build_union(const unsigned char* recs,
                                            uint32_t stride, int n, int nwp,
                                            unsigned char* ut,
                                            const FlatUnion& ul) {
  using rl = FlatRecord;
  uint32_t* ubits = reinterpret_cast<uint32_t*>(ut);
  uint16_t* urank = reinterpret_cast<uint16_t*>(ut + ul.rank);
  float* uvals = reinterpret_cast<float*>(ut + ul.vals);
  int* scratch = reinterpret_cast<int*>(ut + ul.scratch);
  auto nnz = [&](int g) {
    return *reinterpret_cast<const int*>(recs + g * stride + rl::nnz);
  };
  auto coord = [&](int g, int j) {
    return reinterpret_cast<const int32_t*>(recs + g * stride +
                                            rl::coords)[j];
  };
  const int t = threadIdx.x - 32;
  bool listed = true;
  for (int g = 0; g < n; ++g) listed &= nnz(g) <= kFlatNnz;
  if (!listed) return false;
  for (int w = t; w < nwp; w += kConsumerThreads) ubits[w] = 0;
  consumers_sync();
  for (int i = t; i < n * kFlatNnz; i += kConsumerThreads) {
    const int g = i / kFlatNnz, j = i % kFlatNnz;
    if (j < nnz(g)) {
      const int c = coord(g, j);
      atomicOr(&ubits[c >> 5], 1u << (c & 31));
    }
  }
  consumers_sync();
  const int chunk = (nwp + kConsumerThreads - 1) / kConsumerThreads;
  const int w0 = min(nwp, t * chunk), w1 = min(nwp, w0 + chunk);
  int mine = 0;
  for (int w = w0; w < w1; ++w) mine += __popc(ubits[w]);
  int size;
  int off = block_scan<seismic::kTileConsumers>(mine, scratch, &size, t,
                                                consumers_sync);
  if (size > kFlatUnion) return false;
  for (int i = t; i < size * kFlatGroup; i += kConsumerThreads)
    uvals[i] = 0.0f;
  for (int w = w0; w < w1; ++w) {
    urank[w] = (uint16_t)off;
    off += __popc(ubits[w]);
  }
  consumers_sync();
  for (int i = t; i < n * kFlatNnz; i += kConsumerThreads) {
    const int g = i / kFlatNnz, j = i % kFlatNnz;
    if (j < nnz(g)) {
      const int c = coord(g, j), w = c >> 5, b = c & 31;
      uvals[kFlatGroup * (urank[w] + __popc(ubits[w] & ((1u << b) - 1u))) +
            g] = reinterpret_cast<const float*>(recs + g * stride +
                                                rl::vals)[j];
    }
  }
  consumers_sync();
  return true;
}

template <int R, int K>
__global__ void __launch_bounds__(seismic::kTileThreads, 2)
router_flat_kernel(const float* __restrict__ q,
                   const int32_t* __restrict__ sum_coords,
                   const uint8_t* __restrict__ sum_q,
                   const float* __restrict__ sum_scale,
                   const float* __restrict__ sum_zero,
                   const int32_t* __restrict__ block_len,
                   float* __restrict__ out, int32_t* __restrict__ scratch,
                   FlatScratch fs, int cut, int nb, int S, int d, int nwp,
                   int tile_rows, uint32_t stage_bytes,
                   uint32_t record_stride) {
  using seismic::kTileConsumers;
  using seismic::kTileStages;
  using seismic::Rows;
  constexpr int kLiveAhead = 16;   // block_len words a lane loads ahead
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kTileStages;
  // per buffer b: a group's records landed, the consumers are done
  uint64_t* gfull = empty + kTileStages;    // [2]
  uint64_t* gempty = gfull + 2;             // [2]
  unsigned char* ring = smem + seismic::kBarrierBytes;
  unsigned char* recs = ring + kTileStages * stage_bytes;   // [2][G]
  using rl = FlatRecord;
  const FlatUnion ul = flat_union(nwp);
  unsigned char* ut = recs + 2 * kFlatGroup * record_stride;  // the table
  FlatDesc* desc = reinterpret_cast<FlatDesc*>(ut + ul.bytes);  // [2]
  const unsigned char* records =
      reinterpret_cast<const unsigned char*>(scratch + fs.records);
  int32_t* ctrl = scratch + fs.ctrl;
  const int32_t* sorted = scratch + fs.sorted;
  const int32_t* groups = scratch + fs.groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const seismic::StageLayout lay = seismic::stage_layout(tile_rows, S);

  seismic::init_ring(full, empty);
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      seismic::mbar_init(gfull + b, 32);
      seismic::mbar_init(gempty + b, kTileConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto slot = [&](int k) { return ring + (k % kTileStages) * stage_bytes; };
  auto rows_at = [&](long long row) -> Rows {
    return {sum_coords + row * S, sum_q + row * S, sum_scale + row,
            sum_zero + row};
  };

  if (warp == 0) {                          // ---- the producer
    const int n_groups = ctrl[0];
    int k = 0;
    // A group as the producer holds it: its table entry, its live rows
    // (up to its last live block) and its pairs (lane j holds pair j).
    // The next group's are read while this group's tiles go out: its
    // table entry first, its block_len row once that entry is in, its
    // pairs at the end.
    int g, list = 0, first = 0, n = 0, n_live = 0, pair = 0;
    int blv[kLiveAhead];
    auto table = [&](int gg) {
      g = gg;
      if (g < n_groups) {
        list = groups[3 * g];
        first = groups[3 * g + 1];
        n = groups[3 * g + 2];
      }
    };
    auto live_load = [&] {
#pragma unroll
      for (int u = 0; u < kLiveAhead; ++u) {
        const int r = lane + 32 * u;
        blv[u] = g < n_groups && r < nb ? block_len[(long long)list * nb + r]
                                        : 0;
      }
    };
    auto live_reduce = [&] {       // then the pairs are read
      int last = -1;
#pragma unroll
      for (int u = 0; u < kLiveAhead; ++u)
        if (blv[u] > 0) last = lane + 32 * u;
      for (int r = lane + 32 * kLiveAhead; g < n_groups && r < nb; r += 32)
        if (block_len[(long long)list * nb + r] > 0) last = r;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
      n_live = last + 1;
      pair = g < n_groups && lane < n ? sorted[first + lane] : 0;
    };
    int next = 0;                           // lane 0: the group after
    if (lane == 0) next = atomicAdd(ctrl + 1, 1);
    table(__shfl_sync(0xffffffffu, next, 0));
    live_load();
    live_reduce();
    if (lane == 0) next = atomicAdd(ctrl + 1, 1);
    for (int gi = 0;; ++gi) {
      const int b = gi & 1;     // this group's buffer, free once the
      if (gi >= 2)              // consumers are done with group gi - 2
        seismic::mbar_wait(gempty + b, ((gi >> 1) - 1) & 1);
      if (g >= n_groups) {
        if (lane == 0) desc[b].n = -1;
        seismic::mbar_arrive(gfull + b);
        return;
      }
      const int c_list = list, c_n = n, c_live = n_live, c_pair = pair;
      const int n_tiles = (c_live + tile_rows - 1) / tile_rows;
      auto issue = [&](int t) {
        if (k >= kTileStages)
          seismic::mbar_wait(empty + k % kTileStages,
                             (k / kTileStages - 1) & 1);
        uint64_t* bar = full + k % kTileStages;
        // the tile's five ranges go out from five lanes at once (its
        // scales, zeros and block_len are too short for a bulk copy, so
        // a lane copies them 16 bytes at a time)
        if (lane < 5) {
          const int rows = min(tile_rows, c_live - t * tile_rows);
          const long long row0 = (long long)c_list * nb + t * tile_rows;
          const Rows rw = rows_at(row0);
          const uint32_t n = (uint32_t)rows * (uint32_t)S;
          const void* src[5] = {rw.c, rw.v, rw.scale, rw.zero,
                                block_len + row0};
          const uint32_t at[5] = {0u, lay.levels, lay.scale, lay.zero,
                                  lay.bytes};
          const uint32_t bytes[5] = {4u * n, n, 4u * rows, 4u * rows,
                                     4u * rows};
          seismic::mbar_expect_tx(
              bar, seismic::bulk_part(
                       reinterpret_cast<uintptr_t>(src[lane]), bytes[lane]));
          seismic::copy_range(slot(k) + at[lane], src[lane], bytes[lane],
                              bar);
        }
        seismic::tile_issued(bar);
        ++k;
      };
      table(__shfl_sync(0xffffffffu, next, 0));       // the next group
      if (lane == 0) next = atomicAdd(ctrl + 1, 1);
      // the records and the descriptor, then the tiles
      if (lane < c_n) desc[b].pair[lane] = c_pair;
      if (lane == 0) {
        desc[b].list = c_list;
        desc[b].n_live = c_live;
        desc[b].n = c_n;
        // every record starts on 16 bytes: all of it or none goes by a
        // bulk copy
        seismic::mbar_expect_tx(
            gfull + b,
            (uint32_t)c_n * seismic::bulk_part(
                                reinterpret_cast<uintptr_t>(records),
                                rl::bytes));
      }
      __syncwarp();
      if (lane < c_n)
        seismic::copy_range(
            recs + (b * kFlatGroup + lane) * record_stride,
            records + (long long)(c_pair / cut) * rl::bytes, rl::bytes,
            gfull + b);
      seismic::tile_issued(gfull + b);
      int t = 0;
      for (; t < min(n_tiles, kTileStages); ++t) issue(t);
      live_load();
      for (; t < n_tiles; ++t) issue(t);
      live_reduce();
    }
  }

  int k = 0;                                // ---- the consumers
  for (int gi = 0;; ++gi) {
    const int b = gi & 1;
    seismic::mbar_wait(gfull + b, (gi >> 1) & 1);
    const FlatDesc* ds = desc + b;
    const int n = ds->n;
    if (n < 0) return;
    const int list = ds->list, n_live = ds->n_live;
    const unsigned char* rb = recs + b * kFlatGroup * record_stride;
    const int n_tiles = (n_live + tile_rows - 1) / tile_rows;
    const uint32_t* ubits = reinterpret_cast<const uint32_t*>(ut);
    const uint16_t* urank = reinterpret_cast<const uint16_t*>(ut + ul.rank);
    const float* uvals = reinterpret_cast<const float*>(ut + ul.vals);
    consumers_sync();             // every warp is done with the last table
    const bool table = build_union(rb, record_stride, n, nwp, ut, ul);
    for (int t = 0; t < n_tiles; ++t, ++k) {
      seismic::mbar_wait(full + k % kTileStages, (k / kTileStages) & 1);
      const unsigned char* src = slot(k);
      const int rows = min(tile_rows, n_live - t * tile_rows);
      const long long row0 = (long long)list * nb + t * tile_rows;
      const Rows g = rows_at(row0);
      const int32_t* bl = reinterpret_cast<const int32_t*>(
          src + lay.bytes +
          (reinterpret_cast<uintptr_t>(block_len + row0) & 15));
      auto row_at = [&](int i) {
        return seismic::tile_row(src, lay, g, i, S);
      };
      if (table) {
        // the group's queries at once, RU rows a warp at a time
        constexpr int RU = R >= 2 ? 2 : 1;
        score_tile<R, RU, K>(ubits, urank, uvals,
                             seismic::tile_base(src, lay, g), bl, rows, S,
                             ds->pair, n, out, nb, (long long)t * tile_rows,
                             warp, lane);
      } else {
        for (int j = 0; j < n; ++j) {
          const int pair = ds->pair[j];
          float* o = out + (long long)pair * nb + t * tile_rows;
          seismic::score_rows<R, K>(
              seismic::QRow{q + (long long)(pair / cut) * d}, rows, S,
              (warp - 1) * R, kTileConsumers * R, lane, row_at,
              [&](int i, float v) { o[i] = bl[i] > 0 ? v : -INFINITY; });
        }
      }
      __syncwarp();
      if (lane == 0) seismic::mbar_arrive(empty + k % kTileStages);
    }
    // the dead rows past the last live block, never read
    const int tail = nb - n_live;
    for (int i = threadIdx.x - 32; i < n * tail; i += kConsumerThreads)
      out[(long long)ds->pair[i / tail] * nb + n_live + i % tail] =
          -INFINITY;
    __syncwarp();
    if (lane == 0) seismic::mbar_arrive(gempty + b);
  }
}

// The list-major route's launch geometry at Q queries of cut probes over
// [L, nb, S] summaries, dimension d, on `sms` SMs: rows per warp, tile
// rows (one pass of the consumer warps), the persistent grid (two blocks
// an SM, at most one per possible group), bitmap words per query, a ring
// stage's bytes (the tile's rows and their block_len), a query record's
// shared-memory stride, the group table's bytes, the main, the groups and
// the bitmap kernel's dynamic shared memory, and the scratch layout.
FlatGeometry flat_geometry(int Q, int cut, int L, int nb, int S, int d,
                           int sms) {
  using seismic::region_bytes;
  FlatGeometry g;
  g.rows_per_warp = seismic::rows_per_warp(S);
  g.tile_rows = seismic::kTileConsumers * g.rows_per_warp;
  g.nwp = flat_bitmap_words(d);
  g.stage_bytes = seismic::stage_layout(g.tile_rows, S).bytes +
                  region_bytes(4u * g.tile_rows);
  g.record_stride = region_bytes(FlatRecord::bytes);
  g.union_bytes = flat_union(g.nwp).bytes;
  g.smem = seismic::kBarrierBytes + seismic::kTileStages * g.stage_bytes +
           2 * kFlatGroup * g.record_stride + g.union_bytes +
           2 * sizeof(FlatDesc);
  g.groups_smem = 4u * (uint32_t)(L + 32);
  g.records_smem = 4u * (uint32_t)g.nwp + 64u;
  g.scratch = flat_scratch(Q, cut, L);
  const long long P = (long long)Q * cut;
  const long long groups_max = P / kFlatGroup + 1 + (P < L ? P : L);
  g.grid = (int)std::min<long long>(groups_max, 2LL * sms);
  return g;
}

bool flat_shapes_ok(int Q, int cut, int L, int nb, int S, int d, int sms) {
  return Q >= 1 && cut >= 1 && L >= 1 && nb >= 1 && S >= 1 && d >= 1 &&
         sms >= 1;
}

template <int R, int K>
int launch_flat(const int32_t* lists, const float* q,
                const int32_t* sum_coords, const uint8_t* sum_q,
                const float* sum_scale, const float* sum_zero,
                const int32_t* block_len, float* out, int32_t* scratch,
                int Q, int cut, int L, int nb, int S, int d,
                const FlatGeometry& g, cudaStream_t stream) {
  const FlatScratch& fs = g.scratch;
  cudaError_t e = cudaFuncSetAttribute(
      router_flat_groups_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)g.groups_smem);
  if (e != cudaSuccess) return (int)e;
  router_flat_groups_kernel<<<1, kFlatGroupsThreads, g.groups_smem,
                              stream>>>(lists, scratch + fs.ctrl,
                                        scratch + fs.rank,
                                        scratch + fs.sorted,
                                        scratch + fs.groups, Q * cut, L);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(router_flat_records_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)g.records_smem);
  if (e != cudaSuccess) return (int)e;
  // launched beside the groups kernel (programmatic dependent launch)
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)Q);
  cfg.blockDim = dim3(kConsumerThreads);
  cfg.dynamicSmemBytes = (size_t)g.records_smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, router_flat_records_kernel, q,
                         reinterpret_cast<unsigned char*>(scratch +
                                                          fs.records),
                         d, g.nwp);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  auto kernel = router_flat_kernel<R, K>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)g.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<g.grid, seismic::kTileThreads, g.smem, stream>>>(
      q, sum_coords, sum_q, sum_scale, sum_zero, block_len, out, scratch, fs,
      cut, nb, S, d, g.nwp, g.tile_rows, g.stage_bytes, g.record_stride);
  return (int)cudaGetLastError();
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

// router_flat's launch geometry (flat_geometry) into out: pairs a group,
// rows per warp, tile rows, persistent grid, bitmap words per query, stage
// bytes, a query record's bytes, non-zeros a record lists, the group
// table's bytes, union coordinates a table holds, dynamic shared memory of
// the main, the groups and the bitmap kernel, scratch words, ring stages.
extern "C" int router_flat_geometry(int Q, int cut, int L, int nb, int S,
                                    int d, int sms, int* out) {
  if (!flat_shapes_ok(Q, cut, L, nb, S, d, sms))
    return (int)cudaErrorInvalidValue;
  const FlatGeometry g = flat_geometry(Q, cut, L, nb, S, d, sms);
  const long long v[] = {kFlatGroup,      g.rows_per_warp, g.tile_rows,
                         g.grid,          g.nwp,           g.stage_bytes,
                         FlatRecord::bytes, kFlatNnz,      g.union_bytes,
                         kFlatUnion,      g.smem,          g.groups_smem,
                         g.records_smem,   g.scratch.words,
                         seismic::kTileStages};
  for (int i = 0; i < 15; ++i) {
    if (v[i] > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    out[i] = (int)v[i];
  }
  return 0;
}

// The list-major route: the groups kernel, the bitmap kernel and the main
// kernel, in that order on `stream`; scratch holds router_flat_geometry's
// scratch words (int32).
extern "C" int router_flat_launch(const int32_t* lists, const float* q,
                                  const int32_t* sum_coords,
                                  const uint8_t* sum_q,
                                  const float* sum_scale,
                                  const float* sum_zero,
                                  const int32_t* block_len, float* out,
                                  int32_t* scratch, int Q, int cut, int L,
                                  int nb, int S, int d, int sms,
                                  cudaStream_t stream) {
  if (!flat_shapes_ok(Q, cut, L, nb, S, d, sms))
    return (int)cudaErrorInvalidValue;
  const FlatGeometry g = flat_geometry(Q, cut, L, nb, S, d, sms);
  if (g.rows_per_warp == 4)
    return launch_flat<4, 3>(lists, q, sum_coords, sum_q, sum_scale,
                             sum_zero, block_len, out, scratch, Q, cut, L, nb,
                             S, d, g, stream);
  return launch_flat<1, 8>(lists, q, sum_coords, sum_q, sum_scale, sum_zero,
                           block_len, out, scratch, Q, cut, L, nb, S, d, g,
                           stream);
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
