// Two tiles of the dense latent product: fp32 multiply-adds on the CUDA
// cores, rows fp32 or int8 widened to fp32 as they are staged.
//
// score_tile, kTileQ queries x kTileRows rows, for the dense scan's exact
// pass (query_fused.cu: mips_topk_exact), whose block also keeps its
// queries' top-k' lists in shared memory and so holds only 8 queries.  The
// block stages kTileK columns of its queries and rows in shared memory
// at a time (the rows transposed to (k, row), the row stride padded so that
// the transposing stores do not collide in a bank), and each thread keeps a
// kTileQ x kTileRowsPerThread register tile: two adjacent rows (one 8-byte
// shared-memory read) against every query (two broadcast reads), 16
// multiply-adds for 3 reads.  The next kTileK columns are loaded into
// registers (16 bytes a load where the rows allow it) while the current
// ones are multiplied, so the loads' latency hides behind the FMAs.  Every
// output sums over k in the same order, so two equal rows score the same
// bits.
#pragma once

#include "common.cuh"

constexpr int kTileThreads = 256;
constexpr int kTileQ = 8;
constexpr int kTileRowsPerThread = 2;
constexpr int kTileRows = kTileRowsPerThread * kTileThreads;
constexpr int kTileK = 16;
constexpr int kTileWs = kTileRows + 2;  // row stride of the staged rows
constexpr int kStage = kTileRows * kTileK / kTileThreads;  // values a thread stages

// Floats of shared memory score_tile works in.
constexpr int kTileSmemFloats = kTileK * kTileQ + kTileK * kTileWs;

// Whether score_tile may load the rows 16 bytes at a time.
template <typename T>
inline bool tile_vectorized(const T* W, int D) {
  return D % (16 / (int)sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
}

// Load columns [k0, k0 + kTileK) of rows [r0, r0 + kTileRows) into v.
template <typename T>
__device__ __forceinline__ void tile_load(const T* __restrict__ W, int row_end, int r0,
                                          int k0, int D, bool vec, float (&v)[kStage]) {
  const int tid = threadIdx.x;
  if (!vec) {                             // one value a load: row e / kTileK, column e % kTileK
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int e = tid + kTileThreads * i, row = r0 + e / kTileK, k = k0 + e % kTileK;
      v[i] = (row < row_end && k < D) ? (float)W[(size_t)row * D + k] : 0.f;
    }
  } else if constexpr (sizeof(T) == 4) {  // 4 fp32 a load, kTileK / 4 loads a row
    constexpr int kPer = kTileK / 4;
#pragma unroll
    for (int i = 0; i < kStage / 4; ++i) {
      const int f = tid + kTileThreads * i, row = r0 + f / kPer, k = k0 + (f % kPer) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < row_end && k < D)
        x = __ldg(reinterpret_cast<const float4*>(W + (size_t)row * D + k));
      v[4 * i] = x.x;
      v[4 * i + 1] = x.y;
      v[4 * i + 2] = x.z;
      v[4 * i + 3] = x.w;
    }
  } else {                                // 16 int8 a load: a row's kTileK columns
    static_assert(kTileK == 16, "one 16-byte load a row");
#pragma unroll
    for (int i = 0; i < kStage / 16; ++i) {
      const int row = r0 + tid + kTileThreads * i;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row < row_end && k0 < D)
        x = __ldg(reinterpret_cast<const uint4*>(W + (size_t)row * D + k0));
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) v[16 * i + j] = (float)(int8_t)((w[j / 4] >> (8 * (j % 4))) & 0xff);
    }
  }
}

// Store what tile_load loaded, transposed to (k, row).
template <typename T>
__device__ __forceinline__ void tile_store(float* ws, bool vec, const float (&v)[kStage]) {
  const int tid = threadIdx.x;
  if (!vec) {
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int e = tid + kTileThreads * i;
      ws[(e % kTileK) * kTileWs + e / kTileK] = v[i];
    }
  } else if constexpr (sizeof(T) == 4) {
    constexpr int kPer = kTileK / 4;
#pragma unroll
    for (int i = 0; i < kStage / 4; ++i) {
      const int f = tid + kTileThreads * i, row = f / kPer, kq = (f % kPer) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) ws[(kq + e) * kTileWs + row] = v[4 * i + e];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kStage / 16; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) ws[j * kTileWs + tid + kTileThreads * i] = v[16 * i + j];
  }
}

// acc[i][j] = <q[b0 + i], W[r0 + kTileRowsPerThread tid + j]>, 0 past B or
// past row_end.  vec: tile_vectorized(W, D).
template <typename T>
__device__ __forceinline__ void score_tile(const float* __restrict__ q, int B, int b0,
                                           const T* __restrict__ W, int row_end, int r0,
                                           int D, bool vec, float* sm,
                                           float (&acc)[kTileQ][kTileRowsPerThread]) {
  static_assert(kTileQ * kTileK <= kTileThreads, "one staged query value a thread");
  static_assert(kTileRowsPerThread == 2, "one 8-byte read of the staged rows");
  float* qs = sm;                    // (kTileK, kTileQ)
  float* ws = sm + kTileK * kTileQ;  // (kTileK, kTileWs)
  const int tid = threadIdx.x;
  const int qi = tid / kTileK, qk = tid % kTileK;  // the query value tid < 128 stages
  const bool stager = tid < kTileQ * kTileK;
#pragma unroll
  for (int i = 0; i < kTileQ; ++i)
#pragma unroll
    for (int j = 0; j < kTileRowsPerThread; ++j) acc[i][j] = 0.f;
  float v[kStage];
  tile_load<T>(W, row_end, r0, 0, D, vec, v);
  float qv = (stager && b0 + qi < B && qk < D) ? q[(size_t)(b0 + qi) * D + qk] : 0.f;
  for (int k0 = 0; k0 < D; k0 += kTileK) {
    tile_store<T>(ws, vec, v);
    if (stager) qs[qk * kTileQ + qi] = qv;
    __syncthreads();
    const int k1 = k0 + kTileK;
    if (k1 < D) {                    // the next columns, in flight during the FMAs
      tile_load<T>(W, row_end, r0, k1, D, vec, v);
      qv = (stager && b0 + qi < B && k1 + qk < D) ? q[(size_t)(b0 + qi) * D + k1 + qk] : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float2 w = *reinterpret_cast<const float2*>(ws + kk * kTileWs + 2 * tid);
      const float4 qa = *reinterpret_cast<const float4*>(qs + kk * kTileQ);
      const float4 qb = *reinterpret_cast<const float4*>(qs + kk * kTileQ + 4);
      const float qx[kTileQ] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      const float wx[kTileRowsPerThread] = {w.x, w.y};
#pragma unroll
      for (int i = 0; i < kTileQ; ++i)
#pragma unroll
        for (int j = 0; j < kTileRowsPerThread; ++j) acc[i][j] = fmaf(qx[i], wx[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// gemm_tile, kGemmRows rows x kGemmQ queries, for the dense scan's filtered
// pass (query_fused.cu) and the all-pairs SQ8 scan (mips_sq8.cu), whose
// blocks keep no per-query state: 128 threads, 8 rows x 8 queries a thread (64 multiply-adds for 4
// 16-byte shared-memory reads), both operands staged kGemmK columns at a
// time in two shared-memory buffers, the next columns loaded into registers
// during the FMAs.  Each score sums over k in ascending order from 0, as
// score_tile's do, so the two tiles give the same bits for the same pair.
// ---------------------------------------------------------------------------

constexpr int kGemmThreads = 128;
constexpr int kGemmRows = 128;   // rows of a block tile, 8 a thread
constexpr int kGemmQ = 64;       // queries of a block tile, 8 a thread
constexpr int kGemmK = 16;
constexpr int kGemmAs = kGemmRows + 4;  // padded strides, 16-byte rows
constexpr int kGemmBs = kGemmQ + 4;

// Columns [k0, k0 + kGemmK) of rows [r0, r0 + kGemmRows): 16 values a thread.
template <typename T>
__device__ __forceinline__ void gemm_load_rows(const T* __restrict__ W, int m, int r0, int k0,
                                               int D, bool vec, float (&v)[16]) {
  const int tid = threadIdx.x;
  if (!vec) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int e = tid + kGemmThreads * i, row = r0 + e / kGemmK, k = k0 + e % kGemmK;
      v[i] = (row < m && k < D) ? (float)W[(size_t)row * D + k] : 0.f;
    }
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = tid + kGemmThreads * i, row = r0 + f / 4, k = k0 + (f % 4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < m && k < D) x = __ldg(reinterpret_cast<const float4*>(W + (size_t)row * D + k));
      v[4 * i] = x.x;
      v[4 * i + 1] = x.y;
      v[4 * i + 2] = x.z;
      v[4 * i + 3] = x.w;
    }
  } else {
    const int row = r0 + tid;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < m && k0 < D) x = __ldg(reinterpret_cast<const uint4*>(W + (size_t)row * D + k0));
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = (float)(int8_t)((w[j / 4] >> (8 * (j % 4))) & 0xff);
  }
}

template <typename T>
__device__ __forceinline__ void gemm_store_rows(float* As, bool vec, const float (&v)[16]) {
  const int tid = threadIdx.x;
  if (!vec) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int e = tid + kGemmThreads * i;
      As[(e % kGemmK) * kGemmAs + e / kGemmK] = v[i];
    }
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = tid + kGemmThreads * i, row = f / 4, kq = (f % 4) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) As[(kq + e) * kGemmAs + row] = v[4 * i + e];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) As[j * kGemmAs + tid] = v[j];
  }
}

// Columns [k0, k0 + kGemmK) of queries [b0, b0 + kGemmQ): 8 values a thread.
__device__ __forceinline__ void gemm_load_q(const float* __restrict__ q, int B, int b0, int k0,
                                            int D, bool vec, float (&u)[8]) {
  const int tid = threadIdx.x;
  if (!vec) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = tid + kGemmThreads * i, b = b0 + e / kGemmK, k = k0 + e % kGemmK;
      u[i] = (b < B && k < D) ? q[(size_t)b * D + k] : 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = tid + kGemmThreads * i, b = b0 + f / 4, k = k0 + (f % 4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (b < B && k < D) x = __ldg(reinterpret_cast<const float4*>(q + (size_t)b * D + k));
      u[4 * i] = x.x;
      u[4 * i + 1] = x.y;
      u[4 * i + 2] = x.z;
      u[4 * i + 3] = x.w;
    }
  }
}

__device__ __forceinline__ void gemm_store_q(float* Bs, bool vec, const float (&u)[8]) {
  const int tid = threadIdx.x;
  if (!vec) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = tid + kGemmThreads * i;
      Bs[(e % kGemmK) * kGemmBs + e / kGemmK] = u[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = tid + kGemmThreads * i, b = f / 4, kq = (f % 4) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) Bs[(kq + e) * kGemmBs + b] = u[4 * i + e];
    }
  }
}

// acc[i][j] = <W[r0 + 8 (tid / 8) + i], q[b0 + 8 (tid % 8) + j]>, 0 past m
// or B.  vec_w: tile_vectorized(W, D); vec_q: q's rows load 16 bytes at a time.
template <typename T>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ q, int B, int b0,
                                          const T* __restrict__ W, int m, int r0, int D,
                                          bool vec_w, bool vec_q, float (&acc)[8][8]) {
  __shared__ __align__(16) float As[2][kGemmK * kGemmAs];
  __shared__ __align__(16) float Bs[2][kGemmK * kGemmBs];
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float v[16], u[8];
  gemm_load_rows<T>(W, m, r0, 0, D, vec_w, v);
  gemm_load_q(q, B, b0, 0, D, vec_q, u);
  gemm_store_rows<T>(As[0], vec_w, v);
  gemm_store_q(Bs[0], vec_q, u);
  __syncthreads();
  const int nk = (D + kGemmK - 1) / kGemmK;
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk) {                 // the next columns, in flight during the FMAs
      gemm_load_rows<T>(W, m, r0, (t + 1) * kGemmK, D, vec_w, v);
      gemm_load_q(q, B, b0, (t + 1) * kGemmK, D, vec_q, u);
    }
#pragma unroll
    for (int kk = 0; kk < kGemmK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk * kGemmAs + ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk * kGemmAs + ty * 8 + 4]);
      const float4 c0 = *reinterpret_cast<const float4*>(&Bs[cur][kk * kGemmBs + tx * 8]);
      const float4 c1 = *reinterpret_cast<const float4*>(&Bs[cur][kk * kGemmBs + tx * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(c[j], a[i], acc[i][j]);
    }
    if (t + 1 < nk) {
      gemm_store_rows<T>(As[cur ^ 1], vec_w, v);
      gemm_store_q(Bs[cur ^ 1], vec_q, u);
    }
    __syncthreads();
  }
}
