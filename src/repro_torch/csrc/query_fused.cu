// The one-launch first stages: query_fused (psi-pool + IVF probe scan +
// top-k', fp32 and SQ8 lists), query_fused_res (the same over residual
// lists) and mips_topk (dense latent scan + top-k', fp32 and SQ8 rows).
//
// Replaces: src/repro/kernels/query_fused.py:query_fused
//   (_query_fused_fp_kernel, _query_fused_sq8_kernel, _pool_psi, _merge_topk),
//   :query_fused_res (_query_fused_res_kernel) and :mips_topk
//   (_mips_topk_fp_kernel, _mips_topk_sq8_kernel).  On the
//   TPU both carry a (1, k') top-k in VMEM scratch across the sequential grid
//   axis (probes, or row tiles) and merge each step's strip into it with the
//   carried entries first, so that earlier flat positions win ties.
//
// Hopper has no sequential grid axis, so the carry becomes a loop inside a
// block, and the tie rule becomes the (score desc, position asc) key of
// topk.cuh, which gives the stable flat top-k's ids whatever the order the
// entries are folded in.
//
// query_fused.  Bound on the H100: device-memory bytes, as the probe scan
// (ivf_probe_scan.cu: about one operation per byte of the lists), plus the
// psi-pool's operations.  Design: one block per query.  The block pools its
// query's tokens with the psi kernel's own code (psi.cuh) into shared
// memory (the (d',) latent, 8 KB at d' = 2048), then walks its nprobe
// probes in order, kChunk slots at a time: each warp scores whole rows, four
// at once for more loads in flight, with the probe scan's row dot
// (common.cuh: the same bits as the scan), pad slots (id < 0) are not
// read, and a slot enters the chunk's fold only if
// it beats the list's k'-th entry (position p * cap + slot), which makes
// most folds empty once the list has filled.  The list, k' (score,
// position) pairs, stays in shared memory; the ids are looked up once at
// the end.  One CUDA launch a call.
//
// query_fused_res.  Bound on the H100: the decode's instructions, as the
// residual probe scan (ivf_probe_res_scan.cu), plus the psi-pool.  Design:
// query_fused's block per query, psi-pool and top-k' fold, with the lists
// scored kResChunk = 1024 slots at a time by the residual scan's own
// scorer (residual.cuh: res_score_chunk, each tile of d' decoded once into
// a table of products), so its candidates are the residual scan's bit for
// bit; the fold after each chunk takes the rows that beat the list's k'-th.
//
// mips_topk.  Bound on the H100: fp32 operations (2 B m d': 12.5 ms at
// B = 256 over 800k live rows of d' = 2048, against 2 ms for their bytes in
// fp32, at the data sheet's 67 TFLOP/s and 3.35 TB/s).  Two passes:
//  - exact (mips_topk_exact): the rows are split over blocks, a block owns
//    kTileQ = 8 queries and one split, scores them a tile of kTileRows rows
//    at a time (tile.cuh: score_tile), scales SQ8 rows and pins invalid
//    rows to NEG (their positions kept), and a warp folds each query's
//    entries that beat its list into the list (k' pairs a query in shared
//    memory); a second launch merges each query's splits.  The lists cap a
//    block at one an SM and 8 queries (4 above k' = 2048, up to 4096, the
//    sharded path's default on one shard), so W is read 32 times from L2 at
//    B = 256: this pass serves small inputs and the sample below.
//  - filtered (mips_topk_filtered), past 128 k' rows: the exact pass over
//    every 32nd row (the wrapper slices it) gives each query a score its
//    final k'-th cannot fall below; a 128-row x 64-query tile
//    (tile.cuh: gemm_tile, no per-query state) scores every row and
//    appends those at or above the bound to the query's candidates; one
//    block a query folds its candidates into the exact top-k'.  Both tiles
//    sum over k in the same order, so the bound holds to the bit.  A query
//    with more candidates than its buffer sets a flag and the wrapper runs
//    the exact pass over every row.
// CUDA launches a call: 2 for the exact pass alone; 4 and 2 memsets with the
// filtered pass (the sample's exact pass, the filter, the selection).
#include "psi.cuh"
#include "residual.cuh"
#include "tile.cuh"
#include "topk.cuh"

namespace {

constexpr int kMaxKp = 2048;  // the largest k' a list holds (the wrapper's MAX_KP)
// The dense scan's largest k' (the wrapper's MAX_KP_DENSE).  Its exact pass
// keeps a list a query in shared memory for kTileQ queries a block up to
// kMaxKp, and for kTileQ / 2 above (4096 x 8 bytes x 8 queries would not fit).
constexpr int kMaxKpDense = 4096;
constexpr int kChunk = 256;  // slots scored between two folds (a power of two)
constexpr int kWarps = kPsiThreads / 32;
constexpr int kRowsAtOnce = 4;  // rows a warp scores together

template <typename T, int C>
__global__ void __launch_bounds__(kPsiThreads)
query_fused_kernel(const float* __restrict__ qt, const uint8_t* __restrict__ qm,
                   const float* __restrict__ W, const float* __restrict__ bias,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   const int* __restrict__ probe, const int* __restrict__ ids,
                   const T* __restrict__ vecs, const float* __restrict__ scales,
                   float* __restrict__ out_s, int* __restrict__ out_i, int B, int Tq,
                   int D, int Dp, int P, int cap, int nlist, int kp, float eps,
                   int vectorized) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int n_in;
  float* qs = sm;                           // the pooled latent, (Dp,)
  float* work = sm + (Dp + 3) / 4 * 4;      // psi's scratch, then the top-k
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  {
    float pooled[C];
#pragma unroll
    for (int c = 0; c < C; ++c) pooled[c] = 0.f;
    psi_segment<C>(qt, qm, W, bias, gamma, beta, nullptr, pooled, b * Tq, Tq, B * Tq,
                   D, Dp, true, eps, work);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = tid + c * kPsiThreads;
      if (j < Dp) qs[j] = pooled[c];
    }
  }
  float* ts = work;                         // the list: kp scores ...
  int* tp = reinterpret_cast<int*>(ts + kp);  // ... and kp flat positions
  float* es = reinterpret_cast<float*>(tp + kp);  // a chunk's entries
  int* ep = reinterpret_cast<int*>(es + kChunk);
  const BlockGroup g;
  __syncthreads();                          // psi's scratch is free
  topk_clear(ts, tp, kp, g);
  if (tid == 0) n_in = 0;
  __syncthreads();

  for (int p = 0; p < P; ++p) {
    const int cl = probe[(size_t)b * P + p];
    if (cl < 0 || cl >= nlist) continue;    // block-uniform
    for (int c0 = 0; c0 < cap; c0 += kChunk) {
      const float th_s = ts[kp - 1];
      const int th_p = tp[kp - 1];
      const int c1 = min(c0 + kChunk, cap);
      // kRowsAtOnce rows a warp at a time (slots r, r + kWarps, ...), pad
      // slots unread
      for (int r = c0 + warp; r < c1; r += kRowsAtOnce * kWarps) {
        const T* rows[kRowsAtOnce];
        bool any = false;
#pragma unroll
        for (int h = 0; h < kRowsAtOnce; ++h) {
          const int rh = r + h * kWarps;
          const size_t slot = (size_t)cl * cap + rh;
          rows[h] = rh < c1 && ids[slot] >= 0 ? vecs + slot * Dp : nullptr;
          any |= rows[h] != nullptr;
        }
        if (!any) continue;                 // warp-uniform
        float s[kRowsAtOnce];
        warp_rows_dot<kRowsAtOnce, T>(rows, qs, Dp, vectorized, lane, s);
#pragma unroll
        for (int h = 0; h < kRowsAtOnce; ++h) {
          const int rh = r + h * kWarps;
          if (rows[h] == nullptr) continue;
          if (scales != nullptr) s[h] = s[h] * scales[(size_t)cl * cap + rh];
          const int pos = p * cap + rh;
          if (lane == 0 && better(s[h], pos, th_s, th_p)) {
            const int at = atomicAdd(&n_in, 1);
            es[at] = s[h];
            ep[at] = pos;
          }
        }
      }
      __syncthreads();                      // the chunk's entries are in
      const int n = n_in;
      __syncthreads();                      // every thread has read n
      if (tid == 0) n_in = 0;
      if (n > 0) {
        bitonic_sort(es, ep, n, g);
        topk_merge<kChunk / kPsiThreads>(ts, tp, kp, es, ep, n, g);
      }
      __syncthreads();                      // n_in = 0 before the next chunk
    }
  }
  for (int i = tid; i < kp; i += kPsiThreads) {
    const int pos = tp[i];
    int id = -1;
    if (pos != kNoPos) id = ids[(size_t)probe[(size_t)b * P + pos / cap] * cap + pos % cap];
    out_s[(size_t)b * kp + i] = ts[i];
    out_i[(size_t)b * kp + i] = id;
  }
}

template <typename T, int C>
int launch_query_fused(const float* qt, const uint8_t* qm, const float* W,
                       const float* bias, const float* gamma, const float* beta,
                       const int* probe, const int* ids, const T* vecs,
                       const float* scales, float* out_s, int* out_i, int B, int Tq,
                       int D, int Dp, int P, int cap, int nlist, int kp, float eps,
                       cudaStream_t stream) {
  if (kp < 1 || kp > kMaxKp) return (int)cudaErrorInvalidValue;
  const int vectorized = (Dp % (16 / (int)sizeof(T)) == 0) &&
                         (reinterpret_cast<uintptr_t>(vecs) % 16 == 0);
  const size_t topk_floats = 2 * (size_t)kp + 2 * kChunk;
  const size_t psi_floats = psi_smem_floats(D, Dp);
  const size_t smem = ((Dp + 3) / 4 * 4 + (psi_floats > topk_floats ? psi_floats : topk_floats))
                      * sizeof(float);
  cudaError_t err = allow_smem(query_fused_kernel<T, C>, smem);
  if (err != cudaSuccess) return (int)err;
  query_fused_kernel<T, C><<<B, kPsiThreads, smem, stream>>>(
      qt, qm, W, bias, gamma, beta, probe, ids, vecs, scales, out_s, out_i, B, Tq, D,
      Dp, P, cap, nlist, kp, eps, vectorized);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_query_fused(const void* qt, const void* qm, const void* W, const void* bias,
                         const void* gamma, const void* beta, const void* probe,
                         const void* ids, const void* vecs, const void* scales,
                         void* out_s, void* out_i, int B, int Tq, int D, int Dp, int P,
                         int cap, int nlist, int kp, float eps, void* stream) {
#define LEMUR_QF(C)                                                                   \
  return launch_query_fused<T, C>(                                                    \
      (const float*)qt, (const uint8_t*)qm, (const float*)W, (const float*)bias,      \
      (const float*)gamma, (const float*)beta, (const int*)probe, (const int*)ids,    \
      (const T*)vecs, (const float*)scales, (float*)out_s, (int*)out_i, B, Tq, D, Dp, \
      P, cap, nlist, kp, eps, (cudaStream_t)stream)
  const int cols = (Dp + kPsiThreads - 1) / kPsiThreads;
  if (cols <= 1) LEMUR_QF(1);
  if (cols <= 2) LEMUR_QF(2);
  if (cols <= 4) LEMUR_QF(4);
  if (cols <= 8) LEMUR_QF(8);
  if (cols <= 16) LEMUR_QF(16);
#undef LEMUR_QF
  return (int)cudaErrorInvalidValue;  // d' > 4096: the wrapper refuses it first
}

// -------------------------------------------------------------------------
// query_fused_res
// -------------------------------------------------------------------------

static_assert(kResThreads == kPsiThreads, "the residual scorer runs on the psi block");

template <int BITS, int C>
__global__ void __launch_bounds__(kPsiThreads)
query_fused_res_kernel(const float* __restrict__ qt, const uint8_t* __restrict__ qm,
                       const float* __restrict__ W, const float* __restrict__ bias,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       const int* __restrict__ probe, const int* __restrict__ ids,
                       const uint8_t* __restrict__ codes, const float* __restrict__ centroids,
                       const float* __restrict__ values, float* __restrict__ out_s,
                       int* __restrict__ out_i, int B, int Tq, int D, int Dp, int P, int cap,
                       int nlist, int kp, float eps) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int n_in;
  float* qs = sm;                           // the pooled latent, (Dp,)
  float* work = sm + (Dp + 3) / 4 * 4;      // psi's scratch, then the top-k and a tile
  const int b = blockIdx.x, tid = threadIdx.x;
  {
    float pooled[C];
#pragma unroll
    for (int c = 0; c < C; ++c) pooled[c] = 0.f;
    psi_segment<C>(qt, qm, W, bias, gamma, beta, nullptr, pooled, b * Tq, Tq, B * Tq,
                   D, Dp, true, eps, work);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = tid + c * kPsiThreads;
      if (j < Dp) qs[j] = pooled[c];
    }
  }
  float* ts = work;                         // the list: kp scores ...
  int* tp = reinterpret_cast<int*>(ts + kp);  // ... and kp flat positions
  float* es = reinterpret_cast<float*>(tp + kp);  // a chunk's entries
  int* ep = reinterpret_cast<int*>(es + kResChunk);
  float* rs = reinterpret_cast<float*>(ep + kResChunk);  // res_score_chunk's
  const float* acc = rs + ResCodes<BITS>::kLevels * kResTileStride;
  const BlockGroup g;
  __syncthreads();                          // psi's scratch is free
  topk_clear(ts, tp, kp, g);
  if (tid == 0) n_in = 0;
  __syncthreads();

  const size_t db = Dp / ResCodes<BITS>::kPer;
  for (int p = 0; p < P; ++p) {
    const int cl = probe[(size_t)b * P + p];
    if (cl < 0 || cl >= nlist) continue;    // block-uniform
    const int* lid = ids + (size_t)cl * cap;
    for (int c0 = 0; c0 < cap; c0 += kResChunk) {
      const float th_s = ts[kp - 1];
      const int th_p = tp[kp - 1];
      const int c1 = min(c0 + kResChunk, cap);
      res_score_chunk<BITS>(codes + (size_t)cl * cap * db, lid, c0, c1,
                            centroids + (size_t)cl * Dp, values, qs, Dp, rs);
      for (int r = c0 + tid; r < c1; r += kPsiThreads) {
        const int pos = p * cap + r;
        if (lid[r] >= 0 && better(acc[r - c0], pos, th_s, th_p)) {
          const int at = atomicAdd(&n_in, 1);
          es[at] = acc[r - c0];
          ep[at] = pos;
        }
      }
      __syncthreads();                      // the chunk's entries are in
      const int n = n_in;
      __syncthreads();                      // every thread has read n
      if (tid == 0) n_in = 0;
      if (n > 0) {
        bitonic_sort(es, ep, n, g);
        topk_merge<kResChunk / kPsiThreads>(ts, tp, kp, es, ep, n, g);
      }
      __syncthreads();                      // n_in = 0 before the next chunk
    }
  }
  for (int i = tid; i < kp; i += kPsiThreads) {
    const int pos = tp[i];
    int id = -1;
    if (pos != kNoPos) id = ids[(size_t)probe[(size_t)b * P + pos / cap] * cap + pos % cap];
    out_s[(size_t)b * kp + i] = ts[i];
    out_i[(size_t)b * kp + i] = id;
  }
}

template <int BITS, int C>
int launch_query_fused_res(const float* qt, const uint8_t* qm, const float* W,
                           const float* bias, const float* gamma, const float* beta,
                           const int* probe, const int* ids, const uint8_t* codes,
                           const float* centroids, const float* values, float* out_s,
                           int* out_i, int B, int Tq, int D, int Dp, int P, int cap,
                           int nlist, int kp, float eps, cudaStream_t stream) {
  if (kp < 1 || kp > kMaxKp) return (int)cudaErrorInvalidValue;
  const size_t list_floats = 2 * (size_t)kp + 2 * kResChunk + res_smem_floats(BITS);
  const size_t psi_floats = psi_smem_floats(D, Dp);
  const size_t smem = ((Dp + 3) / 4 * 4 + (psi_floats > list_floats ? psi_floats : list_floats))
                      * sizeof(float);
  cudaError_t err = allow_smem(query_fused_res_kernel<BITS, C>, smem);
  if (err != cudaSuccess) return (int)err;
  query_fused_res_kernel<BITS, C><<<B, kPsiThreads, smem, stream>>>(
      qt, qm, W, bias, gamma, beta, probe, ids, codes, centroids, values, out_s, out_i, B,
      Tq, D, Dp, P, cap, nlist, kp, eps);
  return (int)cudaGetLastError();
}

template <int BITS>
int dispatch_query_fused_res(const void* qt, const void* qm, const void* W, const void* bias,
                             const void* gamma, const void* beta, const void* probe,
                             const void* ids, const void* codes, const void* centroids,
                             const void* values, void* out_s, void* out_i, int B, int Tq,
                             int D, int Dp, int P, int cap, int nlist, int kp, float eps,
                             void* stream) {
#define LEMUR_QFR(C)                                                                  \
  return launch_query_fused_res<BITS, C>(                                             \
      (const float*)qt, (const uint8_t*)qm, (const float*)W, (const float*)bias,      \
      (const float*)gamma, (const float*)beta, (const int*)probe, (const int*)ids,    \
      (const uint8_t*)codes, (const float*)centroids, (const float*)values,           \
      (float*)out_s, (int*)out_i, B, Tq, D, Dp, P, cap, nlist, kp, eps,               \
      (cudaStream_t)stream)
  const int cols = (Dp + kPsiThreads - 1) / kPsiThreads;
  if (cols <= 1) LEMUR_QFR(1);
  if (cols <= 2) LEMUR_QFR(2);
  if (cols <= 4) LEMUR_QFR(4);
  if (cols <= 8) LEMUR_QFR(8);
  if (cols <= 16) LEMUR_QFR(16);
#undef LEMUR_QFR
  return (int)cudaErrorInvalidValue;  // d' > 4096: the wrapper refuses it first
}

// -------------------------------------------------------------------------
// mips_topk
// -------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
mips_topk_split_kernel(const float* __restrict__ q, const T* __restrict__ Wr,
                       const float* __restrict__ scales, const uint8_t* __restrict__ valid,
                       float* __restrict__ part_s, int* __restrict__ part_p, int B, int m,
                       int D, int kp, int nq, int rows_per_split, int vec) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int n_in[kTileQ];
  __shared__ float th_s[kTileQ];
  __shared__ int th_p[kTileQ];
  constexpr int kSplitWarps = kTileThreads / 32;
  float* ts = sm + kTileSmemFloats;                         // nq lists of kp
  int* tp = reinterpret_cast<int*>(ts + nq * kp);
  float* es = reinterpret_cast<float*>(tp + nq * kp);       // a tile's entries
  int* ep = reinterpret_cast<int*>(es + nq * kTileRows);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.x * nq, split = blockIdx.y, S = gridDim.y;
  const int b_end = min(B, b0 + nq);  // the tile scores no query past this block's
  const int row0 = split * rows_per_split;
  const int row1 = min(m, row0 + rows_per_split);
  const WarpGroup g;
  // warp w owns the lists of queries b0 + w, b0 + w + kSplitWarps, ...
  for (int i = warp; i < nq; i += kSplitWarps) {
    topk_clear(ts + i * kp, tp + i * kp, kp, g);
    if (lane == 0) {
      n_in[i] = 0;
      th_s[i] = -INFINITY;
      th_p[i] = kNoPos;
    }
  }
  __syncthreads();

  for (int r0 = row0; r0 < row1; r0 += kTileRows) {
    float acc[kTileQ][kTileRowsPerThread];
    score_tile<T>(q, b_end, b0, Wr, row1, r0, D, vec != 0, sm, acc);
#pragma unroll
    for (int j = 0; j < kTileRowsPerThread; ++j) {
      const int row = r0 + kTileRowsPerThread * tid + j;
      if (row >= row1) continue;
      const float sc = scales != nullptr ? scales[row] : 1.f;
      const bool ok = valid == nullptr || valid[row] != 0;
#pragma unroll
      for (int i = 0; i < kTileQ; ++i) {
        if (b0 + i >= b_end) break;
        float s = scales != nullptr ? acc[i][j] * sc : acc[i][j];
        if (!ok) s = LEMUR_NEG;
        if (better(s, row, th_s[i], th_p[i])) {
          const int at = atomicAdd(&n_in[i], 1);
          es[i * kTileRows + at] = s;
          ep[i * kTileRows + at] = row;
        }
      }
    }
    __syncthreads();
    for (int i = warp; i < nq; i += kSplitWarps) {
      const int n = n_in[i];
      if (n == 0) continue;                                 // warp-uniform
      float* e_s = es + i * kTileRows;
      int* e_p = ep + i * kTileRows;
      bitonic_sort(e_s, e_p, n, g);
      topk_merge<kTileRows / 32>(ts + i * kp, tp + i * kp, kp, e_s, e_p, n, g);
      if (lane == 0) {
        n_in[i] = 0;
        th_s[i] = ts[i * kp + kp - 1];
        th_p[i] = tp[i * kp + kp - 1];
      }
    }
    __syncthreads();
  }
  for (int i = warp; i < nq; i += kSplitWarps) {
    if (b0 + i >= B) break;
    const size_t o = ((size_t)(b0 + i) * S + split) * kp;
    for (int e = lane; e < kp; e += 32) {
      part_s[o + e] = ts[i * kp + e];
      part_p[o + e] = tp[i * kp + e];
    }
  }
}

constexpr int kMergeThreads = 256;
constexpr int kMergeMaxPer = kMaxKpDense / kMergeThreads;

__global__ void __launch_bounds__(kMergeThreads)
mips_topk_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_p,
                       float* __restrict__ out_s, int* __restrict__ out_i, int S, int kp) {
  extern __shared__ __align__(16) float sm[];
  float* ts = sm;
  int* tp = reinterpret_cast<int*>(ts + kp);
  float* es = reinterpret_cast<float*>(tp + kp);
  int* ep = reinterpret_cast<int*>(es + kp);
  const BlockGroup g;
  const size_t base = (size_t)blockIdx.x * S * kp;
  for (int i = g.rank(); i < kp; i += g.size()) {
    ts[i] = part_s[base + i];
    tp[i] = part_p[base + i];
  }
  g.sync();
  for (int s = 1; s < S; ++s) {
    const float* ps = part_s + base + (size_t)s * kp;
    const int* pp = part_p + base + (size_t)s * kp;
    // the split's list is sorted: the entries that beat the k'-th are a prefix
    const int n = count_better(ps, pp, kp, ts[kp - 1], tp[kp - 1]);
    for (int i = g.rank(); i < n; i += g.size()) {
      es[i] = ps[i];
      ep[i] = pp[i];
    }
    g.sync();
    if (n > 0) topk_merge<kMergeMaxPer>(ts, tp, kp, es, ep, n, g);
  }
  for (int i = g.rank(); i < kp; i += g.size()) {
    out_s[(size_t)blockIdx.x * kp + i] = ts[i];
    out_i[(size_t)blockIdx.x * kp + i] = tp[i] == kNoPos ? -1 : tp[i];
  }
}

template <typename T>
int launch_mips_topk(const float* q, const T* W, const float* scales, const uint8_t* valid,
                     float* part_s, int* part_p, float* out_s, int* out_i, int B, int m,
                     int D, int kp, int S, cudaStream_t stream) {
  if (kp < 1 || kp > kMaxKpDense) return (int)cudaErrorInvalidValue;
  const int nq = kp > kMaxKp ? kTileQ / 2 : kTileQ;  // queries a block (the wrapper's too)
  const int tiles = (m + kTileRows - 1) / kTileRows;
  const int rows_per_split = (tiles + S - 1) / S * kTileRows;
  const size_t smem = (kTileSmemFloats + 2 * (size_t)nq * kp + 2 * (size_t)nq * kTileRows)
                      * sizeof(float);
  cudaError_t err = allow_smem(mips_topk_split_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((B + nq - 1) / nq), (unsigned)S);
  mips_topk_split_kernel<T><<<grid, kTileThreads, smem, stream>>>(
      q, W, scales, valid, part_s, part_p, B, m, D, kp, nq, rows_per_split,
      (int)tile_vectorized(W, D));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t msmem = 4 * (size_t)kp * sizeof(float);
  err = allow_smem(mips_topk_merge_kernel, msmem);
  if (err != cudaSuccess) return (int)err;
  mips_topk_merge_kernel<<<B, kMergeThreads, msmem, stream>>>(part_s, part_p, out_s, out_i,
                                                              S, kp);
  return (int)cudaGetLastError();
}


// -------------------------------------------------------------------------
// mips_topk over many rows: the product in large tiles, filtered against a
// lower bound of each query's k'-th score, then an exact selection
// -------------------------------------------------------------------------

// One block: kGemmRows rows x kGemmQ queries (tile.cuh: gemm_tile).  Scores
// at or above their query's bound are appended to its candidates (one
// atomic a thread and query).
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
mips_filter_kernel(const float* __restrict__ q, const T* __restrict__ W,
                   const float* __restrict__ scales, const uint8_t* __restrict__ valid,
                   const float* __restrict__ thr, int* __restrict__ cnt,
                   float* __restrict__ buf_s, int* __restrict__ buf_p, int cap, int B, int m,
                   int D, int vec_w, int vec_q) {
  __shared__ float th[kGemmQ];
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int b0 = blockIdx.x * kGemmQ, r0 = blockIdx.y * kGemmRows;
  if (tid < kGemmQ) th[tid] = b0 + tid < B ? thr[b0 + tid] : INFINITY;
  float acc[8][8];
  gemm_tile<T>(q, B, b0, W, m, r0, D, vec_w != 0, vec_q != 0, acc);
  float sc[8];
  bool ok[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + ty * 8 + i;
    ok[i] = row < m && (valid == nullptr || valid[row] != 0);
    sc[i] = row < m && scales != nullptr ? scales[row] : 1.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int b = b0 + tx * 8 + j;
    if (b >= B) break;
    const float bound = th[tx * 8 + j];
    float s[8];
    int n = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[i] = scales != nullptr ? acc[i][j] * sc[i] : acc[i][j];
      if (!ok[i]) s[i] = LEMUR_NEG;
      n += (r0 + ty * 8 + i < m && s[i] >= bound);
    }
    if (n == 0) continue;
    int at = atomicAdd(&cnt[b], n);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (r0 + ty * 8 + i < m && s[i] >= bound) {
        if (at < cap) {
          buf_s[(size_t)b * cap + at] = s[i];
          buf_p[(size_t)b * cap + at] = r0 + ty * 8 + i;
        }
        ++at;
      }
    }
  }
}

constexpr int kSelThreads = 256;
constexpr int kSelChunk = 1024;  // candidates read between two folds

// One block a query: the exact top-k' of its candidates, a chunk at a time.
__global__ void __launch_bounds__(kSelThreads)
mips_select_kernel(const int* __restrict__ cnt, const float* __restrict__ buf_s,
                   const int* __restrict__ buf_p, int cap, float* __restrict__ out_s,
                   int* __restrict__ out_i, int* __restrict__ overflow, int kp) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int n_in;
  float* ts = sm;
  int* tp = reinterpret_cast<int*>(ts + kp);
  float* es = reinterpret_cast<float*>(tp + kp);
  int* ep = reinterpret_cast<int*>(es + kSelChunk);
  const BlockGroup g;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int total = cnt[b];
  if (total > cap) {                  // block-uniform: the caller rescans
    if (tid == 0) *overflow = 1;
    return;
  }
  topk_clear(ts, tp, kp, g);
  if (tid == 0) n_in = 0;
  __syncthreads();
  for (int c0 = 0; c0 < total; c0 += kSelChunk) {
    const float th_s = ts[kp - 1];
    const int th_p = tp[kp - 1];
    for (int i = c0 + tid; i < min(c0 + kSelChunk, total); i += kSelThreads) {
      const float s = buf_s[(size_t)b * cap + i];
      const int p = buf_p[(size_t)b * cap + i];
      if (better(s, p, th_s, th_p)) {
        const int at = atomicAdd(&n_in, 1);
        es[at] = s;
        ep[at] = p;
      }
    }
    __syncthreads();
    const int n = n_in;
    __syncthreads();
    if (tid == 0) n_in = 0;
    if (n > 0) {
      bitonic_sort(es, ep, n, g);
      topk_merge<kSelChunk / kSelThreads>(ts, tp, kp, es, ep, n, g);
    }
    __syncthreads();
  }
  for (int i = tid; i < kp; i += kSelThreads) {
    out_s[(size_t)b * kp + i] = ts[i];
    out_i[(size_t)b * kp + i] = tp[i] == kNoPos ? -1 : tp[i];
  }
}

template <typename T>
int launch_filtered(const float* q, const T* W, const float* scales, const uint8_t* valid,
                    const float* thr, int* cnt, float* buf_s, int* buf_p, int cap,
                    float* out_s, int* out_i, int* overflow, int B, int m, int D, int kp,
                    cudaStream_t stream) {
  if (kp < 1 || kp > kMaxKpDense) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(cnt, 0, (size_t)B * sizeof(int), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(overflow, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const int vec_w = tile_vectorized(W, D);
  const int vec_q = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const dim3 grid((unsigned)((B + kGemmQ - 1) / kGemmQ), (unsigned)((m + kGemmRows - 1) / kGemmRows));
  mips_filter_kernel<T><<<grid, kGemmThreads, 0, stream>>>(
      q, W, scales, valid, thr, cnt, buf_s, buf_p, cap, B, m, D, vec_w, vec_q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (2 * (size_t)kp + 2 * kSelChunk) * sizeof(float);
  err = allow_smem(mips_select_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  mips_select_kernel<<<B, kSelThreads, smem, stream>>>(cnt, buf_s, buf_p, cap, out_s, out_i,
                                                       overflow, kp);
  return (int)cudaGetLastError();
}

}  // namespace

// scales == nullptr: fp32 lists; else int8 codes with per-slot scales.
// qm may be null (every token counts).  Outputs (B, kp) scores and ids.
extern "C" int query_fused_fp32(const void* qt, const void* qm, const void* W,
                                const void* bias, const void* gamma, const void* beta,
                                const void* probe, const void* ids, const void* vecs,
                                void* out_s, void* out_i, int B, int Tq, int D, int Dp,
                                int P, int cap, int nlist, int kp, float eps, void* stream) {
  return dispatch_query_fused<float>(qt, qm, W, bias, gamma, beta, probe, ids, vecs,
                                     nullptr, out_s, out_i, B, Tq, D, Dp, P, cap, nlist,
                                     kp, eps, stream);
}

extern "C" int query_fused_sq8(const void* qt, const void* qm, const void* W,
                               const void* bias, const void* gamma, const void* beta,
                               const void* probe, const void* ids, const void* codes,
                               const void* scales, void* out_s, void* out_i, int B, int Tq,
                               int D, int Dp, int P, int cap, int nlist, int kp, float eps,
                               void* stream) {
  return dispatch_query_fused<int8_t>(qt, qm, W, bias, gamma, beta, probe, ids, codes,
                                      scales, out_s, out_i, B, Tq, D, Dp, P, cap, nlist,
                                      kp, eps, stream);
}

// codes (nlist, cap, Dp * bits / 8) uint8 against each list's own centroid;
// centroids (nlist, Dp), values (Dp, 2^bits) fp32; bits 2 or 4.  Otherwise
// as query_fused_fp32.
extern "C" int query_fused_res(const void* qt, const void* qm, const void* W,
                               const void* bias, const void* gamma, const void* beta,
                               const void* probe, const void* ids, const void* codes,
                               const void* centroids, const void* values, void* out_s,
                               void* out_i, int B, int Tq, int D, int Dp, int P, int cap,
                               int nlist, int kp, int bits, float eps, void* stream) {
  if (bits == 4)
    return dispatch_query_fused_res<4>(qt, qm, W, bias, gamma, beta, probe, ids, codes,
                                       centroids, values, out_s, out_i, B, Tq, D, Dp, P,
                                       cap, nlist, kp, eps, stream);
  if (bits == 2)
    return dispatch_query_fused_res<2>(qt, qm, W, bias, gamma, beta, probe, ids, codes,
                                       centroids, values, out_s, out_i, B, Tq, D, Dp, P,
                                       cap, nlist, kp, eps, stream);
  return (int)cudaErrorInvalidValue;
}

// W: (m, D) fp32 (scales null) or int8 codes with (m,) scales; valid: (m,)
// bytes or null.  part_s / part_p: (B, S, kp) scratch.  Outputs (B, kp)
// scores and row positions.  Two launches.
extern "C" int mips_topk_exact(const void* q, const void* W, const void* scales,
                               const void* valid, void* part_s, void* part_p, void* out_s,
                               void* out_i, int B, int m, int D, int kp, int S, int sq8,
                               void* stream) {
  if (sq8)
    return launch_mips_topk<int8_t>((const float*)q, (const int8_t*)W, (const float*)scales,
                                    (const uint8_t*)valid, (float*)part_s, (int*)part_p,
                                    (float*)out_s, (int*)out_i, B, m, D, kp, S,
                                    (cudaStream_t)stream);
  return launch_mips_topk<float>((const float*)q, (const float*)W, nullptr,
                                 (const uint8_t*)valid, (float*)part_s, (int*)part_p,
                                 (float*)out_s, (int*)out_i, B, m, D, kp, S,
                                 (cudaStream_t)stream);
}

// The filtered pass: thr (B,) a lower bound of each query's k'-th score
// (mips_topk_exact over a sample of the rows); cnt (B,) int, buf_s / buf_p
// (B, cap) candidate scratch; overflow (1,) int, set when a query had more
// than cap candidates (its outputs are then not written).  Two memsets and
// two launches.
extern "C" int mips_topk_filtered(const void* q, const void* W, const void* scales,
                                  const void* valid, const void* thr, void* cnt, void* buf_s,
                                  void* buf_p, int cap, void* out_s, void* out_i,
                                  void* overflow, int B, int m, int D, int kp, int sq8,
                                  void* stream) {
  if (sq8)
    return launch_filtered<int8_t>((const float*)q, (const int8_t*)W, (const float*)scales,
                                   (const uint8_t*)valid, (const float*)thr, (int*)cnt,
                                   (float*)buf_s, (int*)buf_p, cap, (float*)out_s,
                                   (int*)out_i, (int*)overflow, B, m, D, kp,
                                   (cudaStream_t)stream);
  return launch_filtered<float>((const float*)q, (const float*)W, nullptr,
                                (const uint8_t*)valid, (const float*)thr, (int*)cnt,
                                (float*)buf_s, (int*)buf_p, cap, (float*)out_s, (int*)out_i,
                                (int*)overflow, B, m, D, kp, (cudaStream_t)stream);
}
