// The IVF scans by list: the grouping of (query, probe) pairs by the list
// they probe, the producer warp that stages a work item's live rows, and
// the SQ8 / fp32 scan body.  ivf_probe_scan.cu launches the scan alone;
// query_fused.cu launches it between its psi-pool and its selection;
// ivf_probe_res_scan.cu runs its own consumers on the same grouping and
// producer.  One body, so the three share their bits and their layout.
//
// Bound on the H100 (the SQ8 scan): device-memory bytes.  Each probed list
// row is d' int8 codes (2 KB at d' = 2048) plus a 4-byte scale, used for
// one fp32 dot of d' multiply-adds a query that probes its list.  A batch
// of 256 queries x 32 probes reads about 3.2 M rows probe by probe, but
// only about 0.8 M distinct live rows (0.49 ms at 3.35 TB/s): nearly every
// live row is probed by some query of the batch, and by about four on
// average.  The multiply-adds (13 GFLOP, 0.2 ms on the CUDA cores) are not
// the limit, but with the exact widening of each code to fp32 they are
// about three instructions a code (0.66 ms of issue at the served shape),
// above the bytes.
//
// Design: the grid is inverted from queries to lists (query grouping).
//  - A launch before the scan (scan_group_kernel, one block) groups the
//    (b, p) pairs by probe[b, p]: a count, a prefix sum and a scatter into
//    a CSR of pairs over the lists (probes outside [0, nlist) form one more
//    group, whose strips are all -inf), and cuts each list's group into
//    chunks of at most Q pairs (Q: the scan's queries a work item).
//  - A work item is (chunk, range of slots): at most Q x range (row,
//    query) pairs, so lopsided lists (k-means leaves a few near cap, and
//    they have many readers) spread over many blocks.  A producer warp
//    (scan_produce) reads the range's ids (ballots: live rows only, any
//    holes), writes -inf at the pads for every pair of the chunk, and
//    brings the live rows of each window of slots into a ring of
//    shared-memory stages with one bulk copy a row (cp.async.bulk on the
//    stage's mbarrier), a ring's depth of windows ahead of the consumers.
//    A window with no live row is not staged.  So each live row comes from
//    device memory once per chunk of queries, not once per query.
//  - In the SQ8 / fp32 scan (ivf_scan_kernel) each consumer warp takes
//    kScanQW of the chunk's queries (q in registers: lane l holds the
//    16-byte chunks l, l + 32, ... it sums) and, where the chunk has fewer
//    queries than the block, every nph-th row of each stage, kScanRows rows
//    at a time: each code is widened once for its kScanQW queries, and the
//    rows' loads and sums are in flight together (kernels/serve_ablation.py
//    measured the choices).
// Bits: a (row, query) score is the one-block-a-query scorer's (common.cuh:
// warp_rows_dot): lane l sums the row's chunks l, l + 32, ... in order,
// each chunk's dot by dot_chunk's fmaf order, then warp_sum, then times the
// row scale; an int8 code is widened exactly by a byte permute and an fp32
// subtract (s8_to_float), not by the conversion instruction, which issues
// at a quarter of the rate.  Rows of d' off whole 16-byte chunks (or not on
// 16 bytes) are scored a value at a time from device memory, as
// warp_rows_dot does; d' past 2,048 reads q from device memory (cached)
// instead of registers; a row past a third of the block's shared memory
// (fp32 d' above about 19,000, int8 above about 77,000) is not staged: the
// consumers read it from device memory, by whole chunks as before.
// Three CUDA launches: the grouping's memset, the grouping, the scan.
// ivf_probe_scan takes 1.39-1.40 ms at the served shape on one NVIDIA H100
// 80GB HBM3 at a 700.00 W power limit (PERF.md §6, row 1).
#pragma once

#include "tc_common.cuh"

constexpr int kScanWarps = 4;                    // consumer warps a block
constexpr int kScanQW = 2;                       // queries a consumer warp (codes widened once)
constexpr int kScanQ = kScanWarps * kScanQW;     // queries a work item
constexpr int kScanThreads = (kScanWarps + 1) * 32;   // and the producer warp
constexpr int kScanMinBlocks = 2;                // blocks an SM (the registers' bound)
constexpr int kScanRows = 2;                     // rows a consumer warp scores at once
constexpr int kScanRange = 256;                  // slots a work item
constexpr int kScanStages = 3;                   // the ring of windows
constexpr int kScanStageBytes = 32 * 1024;       // rows of a window (at most 32 slots)
constexpr int kScanQRegDims = 2048;              // q in registers up to this d'
constexpr int kGroupThreads = 1024;

// A work item's chunk: the list (nlist: out-of-range probes), the first of
// its pairs in the CSR and their number.
struct ScanChunk {
  int list, first, n, pad_;
};

// One block: pairs grouped by list.  cnt: nlist + 1 ints, zeroed before
// (then the scatter's cursors); pairs: b * P + p in list order (any order
// within a list); chunks: the work items' chunks in list order, at most Q
// pairs each; nchunks[0]: their count, nchunks[1]: 0 (a persistent scan's
// work counter).
template <int Q>
__global__ void __launch_bounds__(kGroupThreads)
scan_group_kernel(const int* __restrict__ probe, int* __restrict__ cnt,
                  int* __restrict__ pairs, ScanChunk* __restrict__ chunks,
                  int* __restrict__ nchunks, int n_pairs, int nlist) {
  __shared__ int wsum[2][kGroupThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto list_of = [&](int i) {
    const int l = probe[i];
    return l < 0 || l >= nlist ? nlist : l;
  };
  for (int i = tid; i < n_pairs; i += kGroupThreads) atomicAdd(&cnt[list_of(i)], 1);
  __syncthreads();
  // exclusive scans of the pairs and the chunks a list, kGroupThreads lists a pass
  int carry_p = 0, carry_c = 0;
  for (int l0 = 0; l0 <= nlist; l0 += kGroupThreads) {
    const int l = l0 + tid;
    const int c = l <= nlist ? cnt[l] : 0;
    const int nc = (c + Q - 1) / Q;
    int ip = c, ic = nc;                         // inclusive warp scans
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int yp = __shfl_up_sync(0xffffffffu, ip, o);
      const int yc = __shfl_up_sync(0xffffffffu, ic, o);
      if (lane >= o) ip += yp, ic += yc;
    }
    if (lane == 31) wsum[0][warp] = ip, wsum[1][warp] = ic;
    __syncthreads();
    int bp = 0, bc = 0, tp = 0, tc = 0;
    for (int w = 0; w < kGroupThreads / 32; ++w) {
      if (w < warp) bp += wsum[0][w], bc += wsum[1][w];
      tp += wsum[0][w], tc += wsum[1][w];
    }
    const int ep = carry_p + bp + ip - c, ec = carry_c + bc + ic - nc;
    if (l <= nlist) {
      cnt[l] = ep;                               // the scatter's cursor
      for (int k = 0; k < nc; ++k)
        chunks[ec + k] = ScanChunk{l, ep + k * Q, min(Q, c - k * Q), 0};
    }
    carry_p += tp;
    carry_c += tc;
    __syncthreads();                             // wsum is read
  }
  if (tid == 0) nchunks[0] = carry_c, nchunks[1] = 0;
  for (int i = tid; i < n_pairs; i += kGroupThreads) pairs[atomicAdd(&cnt[list_of(i)], 1)] = i;
}

// The chunks' bound (a scan's grid.x): a list's pairs make ceil(n / Q) chunks.
inline long long max_chunks(long long n_pairs, int nlist, int Q) {
  const long long groups = n_pairs < nlist + 1LL ? n_pairs : nlist + 1LL;
  return (n_pairs + (long long)(Q - 1) * groups) / Q + 1;
}

// Words of int32 scratch a grouping needs.
inline long long scratch_words(long long n_pairs, int nlist, int Q) {
  return 4 * max_chunks(n_pairs, nlist, Q) + (nlist + 1) + n_pairs + 2;
}

// The grouping in a caller's scratch (scratch_words ints): two launches
// (the counts' memset, scan_group_kernel).
struct ScanGroups {
  const ScanChunk* chunks;
  const int* pairs;
  int* nchunks;                                  // the count, then the work counter
  long long gx;                                  // the chunks' bound
};

template <int Q>
inline cudaError_t group_pairs(const int* probe, int* scratch, long long n_pairs, int nlist,
                               ScanGroups* out, cudaStream_t stream) {
  const long long gx = max_chunks(n_pairs, nlist, Q);
  if (n_pairs >= (1LL << 31) || gx >= (1LL << 31)) return cudaErrorInvalidValue;
  ScanChunk* chunks = reinterpret_cast<ScanChunk*>(scratch);
  int* cnt = scratch + 4 * gx;
  int* pairs = cnt + nlist + 1;
  int* nch = pairs + n_pairs;
  cudaError_t err = cudaMemsetAsync(cnt, 0, (size_t)(nlist + 1) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  scan_group_kernel<Q><<<1, kGroupThreads, 0, stream>>>(probe, cnt, pairs, chunks, nch,
                                                        (int)n_pairs, nlist);
  *out = ScanGroups{chunks, pairs, nch, gx};
  return cudaGetLastError();
}

// A stage's header after the ring: the live rows' slots and scales, their
// number (-1: the range is done) and the work item's tag.
struct alignas(16) StageHdr {
  int slot[32];
  float scale[32];
  int n, item;
};

// A stage's retirement: nothing (the consumers write the scores).
struct NoRetire {
  static constexpr bool kActive = false;
  __device__ void operator()(int) const {}
};

// Stage `staged` of the ring for the producer to fill: it waits for the
// consumers to be done with the stage's last contents and, Retire::kActive,
// retires them (retire(stage), its header intact, ending in __syncwarp).
template <int STAGES, typename Retire>
__device__ __forceinline__ int scan_next_stage(uint64_t* empty, int staged,
                                               const Retire& retire) {
  const int st = staged % STAGES;
  if (staged >= STAGES) {
    mbar_wait(&empty[st], ((staged / STAGES) - 1) & 1);
    if constexpr (Retire::kActive) retire(st);
  }
  return st;
}

// The producer warp of a work item: slots [r0, r1) of the list whose first
// slot is `base`, for the g pairs cp[0 .. g).  It writes -inf at the pads
// for every pair, and hands the consumers the live rows of each window of
// `win` slots through the ring's next stage: their slots and scales (1 for
// null scales) and `item` in the stage's header and, STAGED, their
// rowbytes bytes (row r at src + r * rowbytes) by one bulk copy a row; a
// stage's header with n = -1 ends the item.  full: one arrival and the
// stage's bytes; empty: the consumer warps' arrivals.  `staged` counts the
// stages filled so far (a persistent block carries it from item to item);
// with an active Retire, scan_drain retires the last ones.
template <int RANGE, int STAGES, bool STAGED, typename Retire = NoRetire>
__device__ __forceinline__ void scan_produce(const int* __restrict__ ids,
                                             const float* __restrict__ scales,
                                             const uint8_t* __restrict__ src, size_t base,
                                             int r0, int r1, const int* cp, int g,
                                             float* __restrict__ out, int cap, int win,
                                             int rowbytes, uint8_t* ring, int stage_bytes,
                                             StageHdr* hdr, uint64_t* full, uint64_t* empty,
                                             int lane, int& staged,
                                             const Retire& retire = Retire{}, int item = 0) {
  constexpr int kTiles = RANGE / 32;
  int id[kTiles];
  float sc[kTiles];
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int r = r0 + 32 * j + lane;
    id[j] = r < r1 ? __ldg(ids + base + r) : -1;
  }
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int r = r0 + 32 * j + lane;
    sc[j] = scales != nullptr && id[j] >= 0 ? __ldg(scales + base + r) : 1.f;
  }
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const unsigned live = __ballot_sync(0xffffffffu, id[j] >= 0);
    const int t0 = r0 + 32 * j;
    if (t0 >= r1) break;
    for (int w0 = 0; w0 < 32; w0 += win) {
      const unsigned wm = win == 32 ? live : (live >> w0) & ((1u << win) - 1u);
      const int nslots = min(win, r1 - t0 - w0);
      if (nslots <= 0) break;
      // the window's pads, for every pair of the chunk
      for (int e = lane; e < g * nslots; e += 32) {
        const int s = e % nslots;
        if (!((wm >> s) & 1u)) out[(size_t)cp[e / nslots] * cap + t0 + w0 + s] = -INFINITY;
      }
      if (wm == 0u) continue;
      const int st = scan_next_stage<STAGES>(empty, staged, retire);
      const bool mine = lane >= w0 && lane < w0 + win && ((live >> lane) & 1u);
      const int idx = mine ? __popc(wm & ((1u << (lane - w0)) - 1u)) : 0;
      if (mine) {
        hdr[st].slot[idx] = t0 + lane;
        hdr[st].scale[idx] = sc[j];
      }
      __syncwarp();
      if (lane == 0) {
        hdr[st].n = __popc(wm);
        hdr[st].item = item;
        if (STAGED) mbar_expect_tx(&full[st], (uint32_t)(__popc(wm) * rowbytes));
        else mbar_arrive(&full[st]);
      }
      __syncwarp();
      if (STAGED && mine)
        bulk_copy_g2s(ring + (size_t)st * stage_bytes + (size_t)idx * rowbytes,
                      src + (base + t0 + lane) * rowbytes, rowbytes, &full[st]);
      ++staged;
    }
  }
  const int st = scan_next_stage<STAGES>(empty, staged, retire);   // the end
  if (lane == 0) {
    hdr[st].n = -1;
    mbar_arrive(&full[st]);
  }
  ++staged;
}

// A persistent producer's last stage: n = -2 (no more work; the consumers
// leave without releasing it), after which the stages still in the
// consumers' hands (they release every other stage, ends included) are
// waited for and retired.
template <int STAGES, typename Retire>
__device__ __forceinline__ void scan_finish(StageHdr* hdr, uint64_t* full, uint64_t* empty,
                                            int staged, int lane, const Retire& retire) {
  const int st = scan_next_stage<STAGES>(empty, staged, retire);
  if (lane == 0) {
    hdr[st].n = -2;
    mbar_arrive(&full[st]);
  }
  for (int k = staged - STAGES + 1 > 0 ? staged - STAGES + 1 : 0; k < staged; ++k) {
    mbar_wait(&empty[k % STAGES], (k / STAGES) & 1);
    retire(k % STAGES);
  }
}

// The served path's dots (whole chunks, q in registers) of R rows with QW
// queries, all their loads and sums in flight together: each code widened
// once for all the queries, each (row, query) sum as row_dot's.
template <typename T, int R, int QW>
__device__ __forceinline__ void rows_dots_reg(const T* const (&rows)[R],
                                              const float (&qr)[QW][kScanQRegDims / 32],
                                              int D, int lane, float (&s)[R][QW]) {
  constexpr int kPer = 16 / sizeof(T);
  const int nchunk = D / kPer;
  float acc[R][QW];
#pragma unroll
  for (int h = 0; h < R; ++h)
#pragma unroll
    for (int u = 0; u < QW; ++u) acc[h][u] = 0.f;
#pragma unroll
  for (int j = 0; j < kScanQRegDims / 32 / kPer; ++j) {
    const int c = lane + 32 * j;
    if (c < nchunk) {
#pragma unroll
      for (int h = 0; h < R; ++h) {
        const uint4 v = reinterpret_cast<const uint4*>(rows[h])[c];
        float x[kPer];                           // the chunk's values as floats
        if constexpr (sizeof(T) == 1) {
          const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                                 v.w ^ 0x80808080u};
#pragma unroll
          for (int k = 0; k < kPer; ++k) x[k] = s8_to_float(w[k / 4], k % 4);
        } else {
          x[0] = __uint_as_float(v.x), x[1] = __uint_as_float(v.y);
          x[2] = __uint_as_float(v.z), x[3] = __uint_as_float(v.w);
        }
#pragma unroll
        for (int u = 0; u < QW; ++u) {
          const float* qv = qr[u] + j * kPer;
          float a = sizeof(T) == 1 ? fmaf(x[0], qv[0], 0.f) : x[0] * qv[0];
#pragma unroll
          for (int k = 1; k < kPer; ++k) a = fmaf(x[k], qv[k], a);
          acc[h][u] += a;
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < R; ++h)
#pragma unroll
    for (int u = 0; u < QW; ++u) s[h][u] = warp_sum(acc[h][u]);
}

// The row's dot with one query, warp_rows_dot's sum (see the header), off
// the served path, q from qg in device memory.  VEC: whole 16-byte chunks
// (the row in a stage, or in device memory where a row does not fit one);
// else a value at a time, the row in device memory.
template <typename T, bool VEC>
__device__ __forceinline__ float row_dot(const T* row, const float* qg, int D, int lane) {
  float acc = 0.f;
  if constexpr (VEC) {
    constexpr int kPer = 16 / sizeof(T);
    const int nchunk = D / kPer;
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
#pragma unroll 4
    for (int c = lane; c < nchunk; c += 32) acc += dot_chunk<T>(r4[c], qg + c * kPer);
  } else {
    for (int k = lane; k < D; k += 32) acc = fmaf((float)row[k], __ldg(qg + k), acc);
  }
  return warp_sum(acc);
}

// VEC: whole 16-byte chunks on 16 bytes; STAGED: the rows come through the
// ring (VEC only), else the consumers read them from device memory; QREG:
// q in registers (STAGED only).
template <typename T, bool VEC, bool STAGED, bool QREG>
__global__ void __launch_bounds__(kScanThreads, kScanMinBlocks)
ivf_scan_kernel(const float* __restrict__ q, const int* __restrict__ ids,
                const T* __restrict__ vecs, const float* __restrict__ scales,
                const int* __restrict__ pairs, const ScanChunk* __restrict__ chunks,
                const int* __restrict__ nchunks, float* __restrict__ out, int P, int cap,
                int D, int nlist, int win) {
  extern __shared__ __align__(128) uint8_t ss[];
  const int rowbytes = D * (int)sizeof(T);
  const int stage_bytes = STAGED ? win * rowbytes : 0;
  StageHdr* hdr = reinterpret_cast<StageHdr*>(ss + kScanStages * stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(hdr + kScanStages);
  uint64_t* empty = full + kScanStages;
  if ((int)blockIdx.x >= *nchunks) return;
  const ScanChunk ck = chunks[blockIdx.x];
  const int r0 = blockIdx.y * kScanRange, r1 = min(cap, r0 + kScanRange);
  const int g = ck.n;
  const int ng = (g + kScanQW - 1) / kScanQW;    // the chunk's query groups, a warp each
  const int nph = kScanWarps / ng;               // consumer warps a group
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* cp = pairs + ck.first;
  if (ck.list >= nlist) {                        // out-of-range probes: strips of -inf
    for (int e = threadIdx.x; e < g * (r1 - r0); e += kScanThreads)
      out[(size_t)cp[e / (r1 - r0)] * cap + r0 + e % (r1 - r0)] = -INFINITY;
    return;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kScanStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], ng * nph);            // lane 0 of each working consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const size_t base = (size_t)ck.list * cap;

  if (warp == kScanWarps) {                      // the producer
    int staged = 0;
    scan_produce<kScanRange, kScanStages, STAGED>(
        ids, scales, reinterpret_cast<const uint8_t*>(vecs), base, r0, r1, cp, g, out, cap,
        win, rowbytes, ss, stage_bytes, hdr, full, empty, lane, staged);
    return;
  }

  if (warp >= ng * nph) return;                  // (a chunk of fewer pairs)
  mbar_wait(&full[0], 0);
  if (hdr[0].n < 0) return;                      // a range of pads only
  const int ph = warp / ng;
  int pr[kScanQW];
  bool real[kScanQW];
  const float* qg[kScanQW];
  float qr[kScanQW][kScanQRegDims / 32];         // (QREG; after the first stage: no q for pads)
#pragma unroll
  for (int u = 0; u < kScanQW; ++u) {
    const int e = (warp % ng) * kScanQW + u;
    real[u] = e < g;
    pr[u] = cp[real[u] ? e : 0];                 // (a group short of kScanQW: repeats one)
    qg[u] = q + (size_t)(pr[u] / P) * D;
    if constexpr (QREG) {
      constexpr int kPer = 16 / sizeof(T);
#pragma unroll
      for (int j = 0; j < kScanQRegDims / 32 / kPer; ++j) {
        const int c = lane + 32 * j;
#pragma unroll
        for (int i = 0; i < kPer; i += 4) {
          const float4 v = c < D / kPer
                               ? __ldg(reinterpret_cast<const float4*>(qg[u] + c * kPer + i))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          qr[u][j * kPer + i] = v.x;
          qr[u][j * kPer + i + 1] = v.y;
          qr[u][j * kPer + i + 2] = v.z;
          qr[u][j * kPer + i + 3] = v.w;
        }
      }
    }
  }
  for (int k = 0;; ++k) {
    const int st = k % kScanStages;
    mbar_wait(&full[st], (k / kScanStages) & 1);
    const int n = hdr[st].n;
    if (n < 0) break;
    // rows i, i + nph, ... of the stage, kScanRows at a time (a missing one
    // repeats the first and is not written)
    for (int i = ph; i < n; i += kScanRows * nph) {
      const T* rows[kScanRows];
#pragma unroll
      for (int h = 0; h < kScanRows; ++h) {
        const int ih = i + h * nph < n ? i + h * nph : i;
        rows[h] = STAGED ? reinterpret_cast<const T*>(ss + (size_t)st * stage_bytes +
                                                      (size_t)ih * rowbytes)
                         : vecs + (base + hdr[st].slot[ih]) * D;
      }
      float sc[kScanRows][kScanQW];
      if constexpr (QREG) {
        rows_dots_reg<T, kScanRows, kScanQW>(rows, qr, D, lane, sc);
      } else {
#pragma unroll
        for (int h = 0; h < kScanRows; ++h)
#pragma unroll
          for (int u = 0; u < kScanQW; ++u) sc[h][u] = row_dot<T, VEC>(rows[h], qg[u], D, lane);
      }
      if (lane == 0) {
#pragma unroll
        for (int h = 0; h < kScanRows; ++h) {
          const int ih = i + h * nph;
          if (ih >= n) continue;
          const int slot = hdr[st].slot[ih];
#pragma unroll
          for (int u = 0; u < kScanQW; ++u)
            if (real[u])
              out[(size_t)pr[u] * cap + slot] =
                  scales != nullptr ? sc[h][u] * hdr[st].scale[ih] : sc[h][u];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
}

inline size_t scan_smem(int stage_bytes) {
  return (size_t)kScanStages * stage_bytes + kScanStages * sizeof(StageHdr) +
         2 * kScanStages * 8;
}

template <typename T, bool VEC, bool STAGED, bool QREG>
int launch_scan(const float* q, const int* ids, const T* vecs, const float* scales,
                const ScanGroups& gr, float* out, int P, int cap, int D, int nlist, int win,
                cudaStream_t stream) {
  const size_t smem = scan_smem(STAGED ? win * D * (int)sizeof(T) : 0);
  auto kernel = ivf_scan_kernel<T, VEC, STAGED, QREG>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)gr.gx, (unsigned)((cap + kScanRange - 1) / kScanRange));
  kernel<<<grid, kScanThreads, smem, stream>>>(q, ids, vecs, scales, gr.pairs, gr.chunks,
                                               gr.nchunks, out, P, cap, D, nlist, win);
  return (int)cudaGetLastError();
}

// The scan of q (B, D) over the probed lists into out (B, P, cap): the
// grouping, then the scan's instance for D and the rows' alignment.
// scratch: ivf_probe_scan_scratch(B, P, nlist) ints.
template <typename T>
int launch_ivf_scan(const float* q, const int* probe, const int* ids, const T* vecs,
                    const float* scales, float* out, int* scratch, int B, int P, int cap,
                    int D, int nlist, cudaStream_t stream) {
  if ((cap + kScanRange - 1) / kScanRange > 65535) return (int)cudaErrorInvalidValue;
  ScanGroups gr;
  cudaError_t err = group_pairs<kScanQ>(probe, scratch, (long long)B * P, nlist, &gr, stream);
  if (err != cudaSuccess) return (int)err;
  // whole 16-byte chunks on 16 bytes (warp_rows_dot's test)
  const bool vec = (D % (16 / (int)sizeof(T)) == 0) &&
                   (reinterpret_cast<uintptr_t>(vecs) % 16 == 0);
  const int rowbytes = D * (int)sizeof(T);
  int win = 32;                                  // slots a window: whole rows in a stage
  while (win > 1 && win * rowbytes > kScanStageBytes) win >>= 1;
  const bool qreg = D <= kScanQRegDims;
  int optin = 0;
  err = smem_optin(&optin);
  if (err != cudaSuccess) return (int)err;
  if (vec && scan_smem(win * rowbytes) <= (size_t)optin) {
    if (qreg)
      return launch_scan<T, true, true, true>(q, ids, vecs, scales, gr, out, P, cap, D, nlist,
                                              win, stream);
    return launch_scan<T, true, true, false>(q, ids, vecs, scales, gr, out, P, cap, D, nlist,
                                             win, stream);
  }
  if (vec)                                       // a row past a third of the block's memory
    return launch_scan<T, true, false, false>(q, ids, vecs, scales, gr, out, P, cap, D, nlist,
                                              32, stream);
  return launch_scan<T, false, false, false>(q, ids, vecs, scales, gr, out, P, cap, D, nlist,
                                             32, stream);
}

// int32 words of the scratch that launch_ivf_scan takes (ivf_probe_scan_sq8 /
// _fp32, query_fused_sq8 / _fp32).
extern "C" long long ivf_probe_scan_scratch(int B, int P, int nlist) {
  return scratch_words((long long)B * P, nlist, kScanQ);
}
