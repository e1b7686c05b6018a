// IVF probe scan over residual lists (packed 2/4-bit codes against each
// list's own centroid), decoded at the source.
//
// Replaces: src/repro/kernels/gather_scan.py:ivf_probe_res_scan
//   (_ivf_scan_res_kernel, _unpack_codes_i32, _residual_values), a
//   scalar-prefetch Pallas kernel with grid (B, nprobe) that DMAs cluster
//   probe[b, p]'s packed (cap, d' bits / 8) codes and its centroid row into
//   VMEM, decodes them there (a select-sum over the levels) and scores the
//   list on the MXU.
//
// Bound on the H100: instructions.  A probed row is d' / 2 bytes at 4 bits
// (1 KB at d' = 2048), a quarter of the SQ8 row, and the served shape's
// distinct live rows are 0.26 ms of bytes; each (row, query) pair costs d'
// codes, 6.5e9 (pair, code) at the served shape (256 queries x 12,471 rows
// x 2,048 codes).  Scored as res_scan scores (residual.cuh: a lookup in a
// q[k] values[k][l] table a code and query), that is a lookup a pair and
// code: 0.78 ms at 32 lookups a clock an SM (the lookup floor).
//
// Design: the grid is inverted from queries to lists, on the SQ8 scan's
// grouping and producer (scan_grouped.cuh): the (b, p) pairs grouped by
// list, a work item a chunk of up to kRsQ = 4 of a list's readers x
// kRsRange slots, each live row staged once a chunk by one bulk copy.  A
// block holds the whole values table (d' x 2^bits, 135 KB at 4 bits and d'
// 2,048) in shared memory, each level's row padded so that the lanes'
// lookups fall in their own banks; so one block fits an SM, and the grid is
// one persistent block an SM that builds the table once (a block an item
// paid its prologue, table and first copies serially, about 100 times an
// SM).  The block runs kRsPipes = 2 pipes on that table, so that one pipe's
// waits (an item's first rows, q and q . c) overlap the other's work: each
// a producer warp that takes work items from a counter, its ring running on
// from item to item, and kRsTileWarps = 4 consumer warps, one a 512-dim
// tile: each scores its tile of every row of its pipe's stages for every
// query of the chunk (q of its tile in registers, 16 values a query and
// lane), extracting each code and looking up values[k][code] once for all
// of them; each query adds its rounded product (__fmul_rn, never an fma).
// So a (pair, code) costs a multiply and an add, the lookups a g-th of the
// pairs' (g the chunk's queries), and q takes 64 registers whatever d' (a
// warp holding a query's whole row would need 64 a query and tile, and
// spills).  A warp reduces its 2 rows x g queries' partial sums together
// (warp_sum_scatter: warp_sum's additions, a third of its shuffles) and
// writes each tile's sum to shared memory; the producer, which waits on a
// stage's consumers before it fills the stage again, adds a row's tiles in
// order, adds q . c (res_list_dot, once a query and item) and writes the
// score.  kernels/residual_ablation.py times this design (i) against one
// product table a query (its `product_table` edits, design (ii): 3.7x
// slower) and the constants' neighbours.  At the served shape it takes
// 1.99-2.02 ms, where the block-a-(query, probe) kernel it replaced took
// 2.74-2.77, on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit
// (PERF.md §6, row 9: its dots issue at 40-50 % of the card's rate).
//
// Bits: each (row, query) score is res_scan's (query_fused_res scores rows
// with it): per 512-dim tile, lane l sums its words l, l + 32, ... and
// within a word the codes in order, each term q[k] values[k][code] rounded
// to fp32, then warp_sum; the tiles are added in order from 0, then q . c.
// Rows that are not whole 4-byte words (d' 2,044 at 4 bits, 2,040 at 2)
// are read from device memory a byte at a time, none past the row, as
// res_tile_rows_bytes reads them; rows that are whole words but not whole
// 16-byte chunks are read from device memory a word at a time (no bulk
// copy); past d' 2,048 a warp takes tiles t, t + 4, ... and reads q and
// values from device memory (cached).
// Three CUDA launches a call: the grouping's memset, the grouping, the scan.
#include "residual.cuh"
#include "scan_grouped.cuh"

namespace {

constexpr int kRsTileWarps = 4;                      // a pipe's consumer warps, one a tile
// pipes a block: a producer warp, its consumers and ring each, on one table
constexpr int kRsPipes = 2;
constexpr int kRsWarps = kRsPipes * kRsTileWarps;    // consumer warps a block
constexpr int kRsQ = 4;                              // queries a work item
constexpr int kRsThreads = (kRsWarps + kRsPipes) * 32;
constexpr int kRsRows = 2;                           // rows a consumer warp scores at once
constexpr int kRsRange = 256;                        // slots a work item
constexpr int kRsStages = 2;                         // a pipe's ring of windows
constexpr int kRsStageBytes = 16 * 1024;             // rows of a window (at most 32 slots)
// q in registers and the table in shared memory up to this d' (a tile a warp)
constexpr int kRsQRegDims = kRsTileWarps * kResTileDims;

static_assert(kRsQ <= kRsTileWarps, "a pipe's consumer warp computes each query's q . c");

// The card's SMs (asked once): the persistent grid.
inline cudaError_t sm_count(int* n) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, v = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached = v;
  }
  *n = cached;
  return cudaSuccess;
}

// Floats of a level's row of the table: a column a dim and a pad word after
// every 32 (res_col's layout over the whole row), whole banks.
__host__ __device__ inline int res_table_stride(int D) {
  return (D + (D + 31) / 32 + 31) / 32 * 32;
}

// Word `word` of a packed row: loaded whole, or assembled from its bytes
// below db (the bytes of a row).
template <bool WHOLE>
__device__ __forceinline__ uint32_t res_word(const uint8_t* row, int word, int db) {
  if constexpr (WHOLE) {
    return reinterpret_cast<const uint32_t*>(row)[word];
  } else {
    uint32_t x = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * word + j < db) x |= (uint32_t)row[4 * word + j] << (8 * j);
    return x;
  }
}

// warp_sum of N values a lane at once (N a power of 2): level o of the
// butterfly (o = 16, 8, ..., 1) adds each lane's value and lane l ^ o's, as
// warp_sum does, so each sum has warp_sum's bits; but while a lane holds
// more than one value it keeps half of them (the half its bit o picks) and
// sends the partner the other half, so the first levels move N / 2, N / 4,
// ... values instead of N.  Returns the sum of value `idx`, which the 32 /
// N lanes with the same high bits hold.
template <int O, int N>
__device__ __forceinline__ void warp_sum_scatter_level(float* x, int lane, int& idx) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool hi = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = hi ? x[i] : x[i + N / 2];
        const float keep = hi ? x[i + N / 2] : x[i];
        x[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      if (hi) idx += N / 2;
      warp_sum_scatter_level<O / 2, N / 2>(x, lane, idx);
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], O);
      warp_sum_scatter_level<O / 2, 1>(x, lane, idx);
    }
  }
}

template <int N>
__device__ __forceinline__ float warp_sum_scatter(float (&x)[N], int lane, int& idx) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "N a power of 2 up to 32");
  idx = 0;
  warp_sum_scatter_level<16, N>(x, lane, idx);
  return x[0];
}

__host__ __device__ constexpr int pow2_ceil(int n) {
  return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2);
}

// Tile t's warp sums (res_scan's per-tile sums) of R rows with G queries:
// q from qr (the warp's tile in registers) or, WIDE, from qg; the values
// from the table Vs (level l, dim k at l stride + res_col(k)) or, WIDE,
// from device memory.  The lane gets the sum of (row, query) idx = row G +
// query (idx < R G; warp_sum_scatter's lanes).
template <int BITS, bool WHOLE, bool WIDE, int R, int G>
__device__ __forceinline__ float res_tile_dots(const uint8_t* const (&rows)[R], int t,
                                               const float (&qr)[G][kResTileDims / 32],
                                               const float* const (&qg)[G], const float* Vs,
                                               int stride, const float* __restrict__ values,
                                               int D, int lane, int& idx) {
  using RC = ResCodes<BITS>;
  constexpr int L = RC::kLevels;
  constexpr int cpw = 32 / BITS;                       // codes a word
  constexpr int kWords = kResTileDims / cpw / 32;      // words a lane a row a tile
  const int db = D * BITS / 8;
  const int k0 = t * kResTileDims;
  const int nk = min(kResTileDims, D - k0), tw = (nk + cpw - 1) / cpw;
  // the column of the lane's first code in a 32-dim stretch (a lane's cpw
  // codes never cross one)
  const int lane_col = lane * cpw + ((lane * cpw) >> 5);
  uint32_t w[R][kWords];
#pragma unroll
  for (int h = 0; h < R; ++h)
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const int wi = lane + 32 * i;
      w[h][i] = wi < tw ? res_word<WHOLE>(rows[h], k0 / cpw + wi, db) : 0u;
    }
  float part[R][G];
#pragma unroll
  for (int h = 0; h < R; ++h)
#pragma unroll
    for (int u = 0; u < G; ++u) part[h][u] = 0.f;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int wi = lane + 32 * i;
    if (wi >= tw) continue;                            // past a short last tile
    const int kc = k0 + 32 * i * cpw;                  // the stretch's first dim
#pragma unroll
    for (int j = 0; j < cpw; ++j) {
      if (!WHOLE && wi * cpw + j >= nk) continue;      // past the row's last code
      const int k = kc + lane * cpw + j;
      const int col = lane_col + kc + (kc >> 5) + j;
#pragma unroll
      for (int h = 0; h < R; ++h) {
        const int c = RC::code(w[h][i], j);
        const float v = WIDE ? __ldg(values + (size_t)k * L + c) : Vs[c * stride + col];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          const float qk = WIDE ? __ldg(qg[u] + k) : qr[u][i * cpw + j];
          part[h][u] += __fmul_rn(qk, v);
        }
      }
    }
  }
  constexpr int N = pow2_ceil(R * G);
  float x[N];
#pragma unroll
  for (int e = 0; e < N; ++e) x[e] = e < R * G ? part[e / G][e % G] : 0.f;
  return warp_sum_scatter(x, lane, idx);
}

// A pipe's shared memory after the block's table: its ring, the stages'
// headers and mbarriers, each stage's tile sums (win rows x kRsQ queries x
// ntiles) and, for the producer's retirement, each stage's queries (gs),
// their pairs (prs) and q . c (qcs).
struct ResSmem {
  float* Vs;                                           // (the block's table)
  uint8_t* ring;
  StageHdr* hdr;
  uint64_t* full;
  uint64_t* empty;
  float* sums;
  float* qcs;                                          // (kRsStages, kRsQ)
  int* prs;                                            // (kRsStages, kRsQ)
  int* gs;                                             // (kRsStages,)
  int stage_bytes, stage_sums;
};

inline __host__ __device__ size_t res_pipe_bytes(int stage_bytes, int win, int ntiles) {
  const size_t b = (size_t)kRsStages * stage_bytes + kRsStages * sizeof(StageHdr) +
                   2 * kRsStages * 8 + (size_t)kRsStages * win * kRsQ * ntiles * sizeof(float) +
                   kRsStages * kRsQ * 2 * 4 + kRsStages * 4;
  return (b + 127) / 128 * 128;
}

inline size_t res_scan_smem(size_t table_bytes, int stage_bytes, int win, int ntiles) {
  return table_bytes + kRsPipes * res_pipe_bytes(stage_bytes, win, ntiles);
}

// Pipe `pipe`'s part of the dynamic shared memory `ss` (the table first).
__device__ __forceinline__ ResSmem res_pipe_smem(uint8_t* ss, size_t table_bytes, int pipe,
                                                 int stage_bytes, int win, int ntiles) {
  ResSmem sm;
  sm.Vs = reinterpret_cast<float*>(ss);
  sm.ring = ss + table_bytes + pipe * res_pipe_bytes(stage_bytes, win, ntiles);
  sm.stage_bytes = stage_bytes;
  sm.hdr = reinterpret_cast<StageHdr*>(sm.ring + kRsStages * stage_bytes);
  sm.full = reinterpret_cast<uint64_t*>(sm.hdr + kRsStages);
  sm.empty = sm.full + kRsStages;
  sm.sums = reinterpret_cast<float*>(sm.empty + kRsStages);
  sm.stage_sums = win * kRsQ * ntiles;
  sm.qcs = sm.sums + (size_t)kRsStages * sm.stage_sums;
  sm.prs = reinterpret_cast<int*>(sm.qcs + kRsStages * kRsQ);
  sm.gs = sm.prs + kRsStages * kRsQ;
  return sm;
}

// A consumer warp's part of a work item of G queries (cp[0 .. g), of the
// list whose first slot is `base` and centroid `cent`), from its pipe's
// ring stage kk on to the item's end (kk is left past it): tiles t, t +
// kRsTileWarps, ... (t = warp, its place in the pipe) of every row of every
// stage, each tile's sums to the stage's sums, and warp u < g query u's
// pair and q . c to the stage's prs[u] and qcs[u] (warp 0: g to gs), for
// the producer's retirement.
template <int BITS, bool WHOLE, bool STAGED, bool WIDE, int G>
__device__ __forceinline__ void res_consume(const float* __restrict__ q, const int* cp, int g,
                                            int P, const uint8_t* __restrict__ codes,
                                            const float* __restrict__ cent,
                                            const float* __restrict__ values, size_t base,
                                            int D, int ntiles, const ResSmem& sm, int stride,
                                            int warp, int lane, int& kk) {
  constexpr int cpw = 32 / BITS, kWords = kResTileDims / cpw / 32;
  const int db = D * BITS / 8;
  const int t0 = warp;
  const float* qg[G];
  float qr[G][kResTileDims / 32];                      // (not WIDE: the lane's dims of tile t0)
#pragma unroll
  for (int u = 0; u < G; ++u) {
    qg[u] = q + (size_t)(cp[u < g ? u : 0] / P) * D;  // (G > g: repeats one, not written)
    if constexpr (!WIDE) {
#pragma unroll
      for (int i = 0; i < kWords; ++i)
#pragma unroll
        for (int j = 0; j < cpw; ++j) {
          const int k = t0 * kResTileDims + (lane + 32 * i) * cpw + j;
          qr[u][i * cpw + j] = k < D ? __ldg(qg[u] + k) : 0.f;
        }
    }
  }
  float qcw = 0.f;                                     // q . c of query `warp`, once an item
  const int myp = warp < g ? cp[warp] : 0;
  if (warp < g) qcw = res_list_dot(q + (size_t)(myp / P) * D, cent, D, lane);
  for (;; ++kk) {
    const int st = kk % kRsStages;
    mbar_wait(&sm.full[st], (kk / kRsStages) & 1);
    const int n = sm.hdr[st].n;
    if (n >= 0) {
      float* sums = sm.sums + (size_t)st * sm.stage_sums;
      if (lane == 0) {
        if (warp < g) sm.qcs[st * kRsQ + warp] = qcw, sm.prs[st * kRsQ + warp] = myp;
        if (warp == 0) sm.gs[st] = g;
      }
      // the stage's rows, kRsRows at a time (a missing one repeats the
      // first and is not written)
      for (int i = 0; i < n; i += kRsRows) {
        const uint8_t* rows[kRsRows];
#pragma unroll
        for (int h = 0; h < kRsRows; ++h) {
          const int ih = i + h < n ? i + h : i;
          rows[h] = STAGED ? sm.ring + (size_t)st * sm.stage_bytes + (size_t)ih * db
                           : codes + (base + sm.hdr[st].slot[ih]) * db;
        }
        for (int t = t0; t < ntiles; t += kRsTileWarps) {
          constexpr int kSums = pow2_ceil(kRsRows * G);   // (lanes a sum: 32 / kSums)
          int idx;
          const float v = res_tile_dots<BITS, WHOLE, WIDE, kRsRows, G>(
              rows, t, qr, qg, sm.Vs, stride, values, D, lane, idx);
          const int ih = i + idx / G, u = idx % G;
          if ((lane & (32 / kSums - 1)) == 0 && idx < kRsRows * G && ih < n && u < g)
            sums[((size_t)ih * kRsQ + u) * ntiles + t] = v;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);
    if (n < 0) {                                       // the item's end
      ++kk;
      return;
    }
  }
}

// The producer's retirement of a stage of rows: each (row, query) score is
// its tiles' sums added in order from 0, then q . c (all from shared
// memory).
struct ResRetire {
  static constexpr bool kActive = true;
  ResSmem sm;
  float* out;
  int cap, ntiles, lane;
  __device__ void operator()(int st) const {
    const int n = sm.hdr[st].n;                        // (-1: an item's end)
    if (n > 0) {
      const int g = sm.gs[st];
      const float* sums = sm.sums + (size_t)st * sm.stage_sums;
      for (int e = lane; e < n * g; e += 32) {
        const int row = e / g, u = e - row * g;
        const float* s = sums + ((size_t)row * kRsQ + u) * ntiles;
        float acc = 0.f;
        for (int t = 0; t < ntiles; ++t) acc += s[t];
        out[(size_t)sm.prs[st * kRsQ + u] * cap + sm.hdr[st].slot[row]] =
            acc + sm.qcs[st * kRsQ + u];
      }
    }
    __syncwarp();
  }
};

// The table of values[k][l] in shared memory, by every consumer warp.
template <int L>
__device__ __forceinline__ void res_build_table(const float* __restrict__ values, float* Vs,
                                                int stride, int D) {
  for (int k = threadIdx.x; k < D; k += kRsWarps * 32) {
    const float4* v4 = reinterpret_cast<const float4*>(values + (size_t)k * L);
    const int col = k + (k >> 5);
#pragma unroll
    for (int l4 = 0; l4 < L / 4; ++l4) {
      const float4 v = __ldg(v4 + l4);
      Vs[(4 * l4 + 0) * stride + col] = v.x;
      Vs[(4 * l4 + 1) * stride + col] = v.y;
      Vs[(4 * l4 + 2) * stride + col] = v.z;
      Vs[(4 * l4 + 3) * stride + col] = v.w;
    }
  }
}

__device__ __forceinline__ void res_consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kRsWarps * 32) : "memory");
}

// A persistent block an SM: kRsPipes pipes, each a producer warp taking
// work items from a counter (item w: range w / nchunks of chunk w %
// nchunks, the lists' first slots, where the rows are, first) and its
// consumer warps following its stages' headers (the item's chunk), its ring
// running on from item to item; the table is built once for all.  WHOLE:
// rows of whole 4-byte words; STAGED: the rows come through the ring (whole
// 16-byte chunks on 16 bytes), else the consumers read them from device
// memory; WIDE: d' past kRsQRegDims, q and values from device memory.
template <int BITS, bool WHOLE, bool STAGED, bool WIDE>
__global__ void __launch_bounds__(kRsThreads, 1)
ivf_res_scan_kernel(const float* __restrict__ q, const int* __restrict__ ids,
                    const uint8_t* __restrict__ codes, const float* __restrict__ centroids,
                    const float* __restrict__ values, const int* __restrict__ pairs,
                    const ScanChunk* __restrict__ chunks, int* __restrict__ nchunks,
                    float* __restrict__ out, int P, int cap, int D, int nlist, int win) {
  extern __shared__ __align__(128) uint8_t ss[];
  constexpr int L = ResCodes<BITS>::kLevels;
  const int db = D * BITS / 8;
  const int stride = res_table_stride(D);
  const int ntiles = (D + kResTileDims - 1) / kResTileDims;
  const int nch = nchunks[0];
  const int nitems = nch * ((cap + kRsRange - 1) / kRsRange);
  if ((int)blockIdx.x >= nitems) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // consumer warps 0 .. kRsWarps - 1 (pipe warp / kRsTileWarps), then a
  // producer warp a pipe
  const int pipe = warp < kRsWarps ? warp / kRsTileWarps : warp - kRsWarps;
  const ResSmem sm = res_pipe_smem(ss, WIDE ? 0 : (size_t)L * stride * sizeof(float), pipe,
                                   STAGED ? win * db : 0, win, ntiles);
  if (warp >= kRsWarps && lane == 0) {
    for (int s = 0; s < kRsStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kRsTileWarps);           // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kRsWarps) {                              // a pipe's producer, and its scores
    const ResRetire rt{sm, out, cap, ntiles, lane};
    int staged = 0;
    int next = lane == 0 ? atomicAdd(nchunks + 1, 1) : 0;   // (lane 0) the next item
    for (int w = __shfl_sync(0xffffffffu, next, 0); w < nitems;
         w = __shfl_sync(0xffffffffu, next, 0)) {
      if (lane == 0) next = atomicAdd(nchunks + 1, 1);  // (its latency hides behind item w)
      const int c = w % nch, r0 = w / nch * kRsRange, r1 = min(cap, r0 + kRsRange);
      const ScanChunk ck = chunks[c];
      const int* cp = pairs + ck.first;
      if (ck.list >= nlist) {                          // out-of-range probes: strips of -inf
        for (int e = lane; e < ck.n * (r1 - r0); e += 32)
          out[(size_t)cp[e / (r1 - r0)] * cap + r0 + e % (r1 - r0)] = -INFINITY;
      } else {
        scan_produce<kRsRange, kRsStages, STAGED>(ids, nullptr, codes, (size_t)ck.list * cap,
                                                  r0, r1, cp, ck.n, out, cap, win, db, sm.ring,
                                                  sm.stage_bytes, sm.hdr, sm.full, sm.empty,
                                                  lane, staged, rt, c);
      }
    }
    scan_finish<kRsStages>(sm.hdr, sm.full, sm.empty, staged, lane, rt);
    return;
  }

  if constexpr (!WIDE) {                               // the table, once a block
    res_build_table<L>(values, sm.Vs, stride, D);
    res_consumers_sync();
  }
  const int tw = warp % kRsTileWarps;                  // the warp's place in its pipe
  for (int kk = 0;;) {                                 // kk: the pipe's next stage
    const int st = kk % kRsStages;
    mbar_wait(&sm.full[st], (kk / kRsStages) & 1);
    const int n = sm.hdr[st].n;
    if (n == -2) break;                                // no more work
    if (n < 0) {                                       // an item of pads only
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[st]);
      ++kk;
      continue;
    }
    const ScanChunk ck = chunks[sm.hdr[st].item];
    const int g = ck.n;
    const int* cp = pairs + ck.first;
    const float* cent = centroids + (size_t)ck.list * D;
    const size_t base = (size_t)ck.list * cap;
#define LEMUR_RES_CONSUME(G)                                                                \
  res_consume<BITS, WHOLE, STAGED, WIDE, G>(q, cp, g, P, codes, cent, values, base, D, ntiles, \
                                            sm, stride, tw, lane, kk)
    switch (g) {
      case 1: LEMUR_RES_CONSUME(1); break;
      case 2: LEMUR_RES_CONSUME(2); break;
      case 3: LEMUR_RES_CONSUME(3); break;
      default: LEMUR_RES_CONSUME(kRsQ); break;
    }
#undef LEMUR_RES_CONSUME
  }
}

template <int BITS, bool WHOLE, bool STAGED, bool WIDE>
int launch_res_scan(const float* q, const int* ids, const uint8_t* codes,
                    const float* centroids, const float* values, const ScanGroups& gr,
                    float* out, int P, int cap, int D, int nlist, int win, cudaStream_t stream) {
  const size_t table = WIDE ? 0 : (size_t)(1 << BITS) * res_table_stride(D) * sizeof(float);
  const size_t smem = res_scan_smem(table, STAGED ? win * (D * BITS / 8) : 0, win,
                                    (D + kResTileDims - 1) / kResTileDims);
  auto kernel = ivf_res_scan_kernel<BITS, WHOLE, STAGED, WIDE>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const long long items = gr.gx * ((cap + kRsRange - 1) / kRsRange);   // (a bound)
  kernel<<<(unsigned)(items < sms ? items : sms), kRsThreads, smem, stream>>>(
      q, ids, codes, centroids, values, gr.pairs, gr.chunks, gr.nchunks, out, P, cap, D, nlist,
      win);
  return (int)cudaGetLastError();
}

template <int BITS>
int launch(const float* q, const int* probe, const int* ids, const uint8_t* codes,
           const float* centroids, const float* values, float* out, int* scratch, int B,
           int P, int cap, int D, int nlist, cudaStream_t stream) {
  ScanGroups gr;
  cudaError_t err = group_pairs<kRsQ>(probe, scratch, (long long)B * P, nlist, &gr, stream);
  if (err != cudaSuccess) return (int)err;
  if (gr.gx * ((cap + kRsRange - 1) / kRsRange) >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int db = D * BITS / 8;
  const bool whole = res_whole_words(codes, D, BITS);
  int win = 32;                                        // slots a window: whole rows in a stage
  while (win > 1 && win * db > kRsStageBytes) win >>= 1;
  const size_t table = D > kRsQRegDims ? 0 : (size_t)(1 << BITS) * res_table_stride(D) * 4;
  int optin = 0;
  err = smem_optin(&optin);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (D + kResTileDims - 1) / kResTileDims;
  const bool staged = whole && db > 0 && db % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(codes) % 16 == 0 &&
                      res_scan_smem(table, win * db, win, ntiles) <= (size_t)optin;
  if (!staged && res_scan_smem(table, 0, win, ntiles) > (size_t)optin)
    return (int)cudaErrorInvalidValue;                 // (d' past about 2.4 million)
#define LEMUR_RES(WHOLE, STAGED)                                                           \
  return (D > kRsQRegDims ? launch_res_scan<BITS, WHOLE, STAGED, true>                     \
                          : launch_res_scan<BITS, WHOLE, STAGED, false>)(                  \
      q, ids, codes, centroids, values, gr, out, P, cap, D, nlist, win, stream)
  if (staged) LEMUR_RES(true, true);
  if (whole) LEMUR_RES(true, false);
  LEMUR_RES(false, false);
#undef LEMUR_RES
}

}  // namespace

// int32 words of the scratch that ivf_probe_res_scan takes.
extern "C" long long ivf_probe_res_scan_scratch(int B, int P, int nlist) {
  return scratch_words((long long)B * P, nlist, kRsQ);
}

// The work items' shape, for the callers' reports: {queries, slots} an item.
extern "C" void ivf_probe_res_scan_item(int* shape) {
  shape[0] = kRsQ;
  shape[1] = kRsRange;
}

// q (B, D) fp32; probe (B, P) int32; ids (nlist, cap) int32; codes (nlist,
// cap, D * bits / 8) uint8; centroids (nlist, D) fp32; values (D, 2^bits)
// fp32 -> out (B, P, cap) fp32.  bits is 2 or 4.  scratch:
// ivf_probe_res_scan_scratch(B, P, nlist) int32 words.
extern "C" int ivf_probe_res_scan(const void* q, const void* probe, const void* ids,
                                  const void* codes, const void* centroids,
                                  const void* values, void* out, void* scratch, int B, int P,
                                  int cap, int D, int nlist, int bits, void* stream) {
#define LEMUR_RES_SCAN(BITS)                                                            \
  return launch<BITS>((const float*)q, (const int*)probe, (const int*)ids,              \
                      (const uint8_t*)codes, (const float*)centroids, (const float*)values, \
                      (float*)out, (int*)scratch, B, P, cap, D, nlist, (cudaStream_t)stream)
  if (bits == 4) LEMUR_RES_SCAN(4);
  if (bits == 2) LEMUR_RES_SCAN(2);
#undef LEMUR_RES_SCAN
  return (int)cudaErrorInvalidValue;
}
