// psi(x) = LN(GELU_tanh(x W' + b)) over one segment of rows, by a whole
// block of kPsiThreads threads: the body of the fused psi kernel
// (fused_psi_pool.cu, where the design is described), shared with the
// one-launch query kernels (query_fused.cu), which pool each query's tokens
// with it.  The same code in all gives the same bits for the same query.
//
// A cluster of CS blocks may pool one segment together (query_fused_res):
// block `rank` of the cluster computes the product and GELU of columns
// tid + 256 c for c = rank, rank + CS, ... (each column's fmaf chain over
// x's row as the single block runs it) and writes them into every block's
// GELU tile through distributed shared memory; after a cluster barrier
// each block takes the LayerNorm statistics and the pool over the full
// rows with the single block's code, so every block holds the single
// block's pooled latent, bit for bit.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

constexpr int kPsiThreads = 256;
constexpr int kPsiRows = kPsiThreads / 32;  // one warp per row for the statistics

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k0 * (x + 0.044715f * x * x * x)));
}

// Floats of shared memory psi_segment works in.
inline size_t psi_smem_floats(int D, int Dp) {
  return (size_t)kPsiRows * D + (size_t)kPsiRows * Dp + 2 * kPsiRows;
}

// Rows [seg0, seg0 + seg_len) (those < n_rows): written to out when pool is
// false; otherwise mask_t * psi(x_t) is added into pooled (column
// tid + kPsiThreads * c of d').  sm: psi_smem_floats(D, Dp) floats.  CS > 1:
// the blocks of a cluster of CS pool the segment together (pool only; every
// block of the cluster calls this with the same arguments).
template <int C, int CS = 1>
__device__ __forceinline__ void psi_segment(
    const float* __restrict__ x, const uint8_t* __restrict__ mask,
    const float* __restrict__ W, const float* __restrict__ bias,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float* __restrict__ out, float (&pooled)[C], int seg0, int seg_len,
    int n_rows, int D, int Dp, bool pool, float eps, float* sm) {
  constexpr int kThreads = kPsiThreads, kRows = kPsiRows;
  constexpr int CC = (C + CS - 1) / CS;  // product columns a thread takes
  float* xs = sm;                       // kRows x D
  float* hs = xs + kRows * D;           // kRows x Dp
  float* stats = hs + (size_t)kRows * Dp;  // kRows x (mean, 1/std)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int rank = 0;
  if constexpr (CS > 1) {
    rank = (int)cooperative_groups::this_cluster().block_rank();
    cooperative_groups::this_cluster().sync();   // every block of the cluster has started
  }

  for (int r0 = 0; r0 < seg_len; r0 += kRows) {
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int r = i / D, row = seg0 + r0 + r;
      xs[i] = (r0 + r < seg_len && row < n_rows) ? x[(size_t)row * D + i % D] : 0.f;
    }
    __syncthreads();

    float acc[kRows][CC];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[r][c] = 0.f;
    if constexpr (CS == 1) {
      for (int k = 0; k < D; ++k) {
        float w[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = tid + c * kThreads;
          w[c] = j < Dp ? __ldg(W + (size_t)k * Dp + j) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xv = xs[r * D + k];
#pragma unroll
          for (int c = 0; c < C; ++c) acc[r][c] = fmaf(xv, w[c], acc[r][c]);
        }
      }
    } else {
      // the block's columns c = rank, rank + CS, ..., each column's fmaf
      // chain as above; 8 steps of k unrolled, their loads of W' in flight
      // together (a block's few columns would wait on them one by one)
#pragma unroll 8
      for (int k = 0; k < D; ++k) {
        float w[CC];
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          const int j = tid + (rank + CS * c) * kThreads;
          w[c] = rank + CS * c < C && j < Dp ? __ldg(W + (size_t)k * Dp + j) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xv = xs[r * D + k];
#pragma unroll
          for (int c = 0; c < CC; ++c) acc[r][c] = fmaf(xv, w[c], acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      const int j = tid + (rank + CS * c) * kThreads;
      if (rank + CS * c < C && j < Dp) {
        const float bj = bias[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float h = gelu_tanh(acc[r][c] + bj);
          if constexpr (CS == 1) {
            hs[(size_t)r * Dp + j] = h;
          } else {
#pragma unroll
            for (int q = 0; q < CS; ++q)
              cooperative_groups::this_cluster().map_shared_rank(hs, q)[(size_t)r * Dp + j] = h;
          }
        }
      }
    }
    if constexpr (CS == 1) __syncthreads();
    else cooperative_groups::this_cluster().sync();   // every block's columns are in

    {  // LayerNorm statistics of row `warp` over the full d'
      const float* h = hs + (size_t)warp * Dp;
      float s = 0.f;
      for (int j = lane; j < Dp; j += 32) s += h[j];
      const float mu = warp_sum(s) / (float)Dp;
      float v = 0.f;
      for (int j = lane; j < Dp; j += 32) {
        const float dv = h[j] - mu;
        v = fmaf(dv, dv, v);
      }
      const float var = warp_sum(v) / (float)Dp;
      if (lane == 0) {
        stats[2 * warp] = mu;
        stats[2 * warp + 1] = 1.f / sqrtf(var + eps);
      }
    }
    __syncthreads();

    for (int r = 0; r < kRows; ++r) {
      const int row = seg0 + r0 + r;
      if (r0 + r >= seg_len || row >= n_rows) break;
      const float mu = stats[2 * r], rstd = stats[2 * r + 1];
      const float m = (pool && mask != nullptr) ? (float)(mask[row] != 0) : 1.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = tid + c * kThreads;
        if (j < Dp) {
          const float y = (hs[(size_t)r * Dp + j] - mu) * rstd * gamma[j] + beta[j];
          if (pool) pooled[c] += y * m;
          else out[(size_t)row * Dp + j] = y;
        }
      }
    }
    // the tile is read (CS > 1: in every block, before the next is written)
    if constexpr (CS == 1) __syncthreads();
    else cooperative_groups::this_cluster().sync();
  }
}

// The fused psi kernel (fused_psi_pool.cu): one block a segment of seg_len
// rows; pool != 0 writes each segment's masked sum (the one-launch
// query_fused pools its queries with it too, so both pools have the same
// bits).
template <int C>
__global__ void __launch_bounds__(kPsiThreads)
fused_psi_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                 const float* __restrict__ W, const float* __restrict__ bias,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 float* __restrict__ out, int n_rows, int seg_len, int D, int Dp,
                 int pool, float eps) {
  extern __shared__ __align__(16) float sm[];
  float pooled[C];
#pragma unroll
  for (int c = 0; c < C; ++c) pooled[c] = 0.f;
  psi_segment<C>(x, mask, W, bias, gamma, beta, out, pooled, blockIdx.x * seg_len,
                 seg_len, n_rows, D, Dp, pool != 0, eps, sm);
  if (pool) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = threadIdx.x + c * kPsiThreads;
      if (j < Dp) out[(size_t)blockIdx.x * Dp + j] = pooled[c];
    }
  }
}

template <int C>
int launch_psi(const float* x, const uint8_t* mask, const float* W, const float* bias,
               const float* gamma, const float* beta, float* out, int n_rows, int seg_len,
               int D, int Dp, int pool, float eps, cudaStream_t stream) {
  const size_t smem = psi_smem_floats(D, Dp) * sizeof(float);
  cudaError_t err = allow_smem(fused_psi_kernel<C>, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_seg = (n_rows + seg_len - 1) / seg_len;
  fused_psi_kernel<C><<<n_seg, kPsiThreads, smem, stream>>>(
      x, mask, W, bias, gamma, beta, out, n_rows, seg_len, D, Dp, pool, eps);
  return (int)cudaGetLastError();
}

// The kernel's instance for d' (C = its columns a thread); d' > 4096 is
// refused (the wrappers refuse it first).
inline int launch_fused_psi(const float* x, const uint8_t* mask, const float* W,
                            const float* bias, const float* gamma, const float* beta,
                            float* out, int n_rows, int seg_len, int D, int Dp, int pool,
                            float eps, cudaStream_t stream) {
  const int cols = (Dp + kPsiThreads - 1) / kPsiThreads;
#define LEMUR_PSI(C)                                                                   \
  return launch_psi<C>(x, mask, W, bias, gamma, beta, out, n_rows, seg_len, D, Dp, pool, \
                       eps, stream)
  if (cols <= 1) LEMUR_PSI(1);
  if (cols <= 2) LEMUR_PSI(2);
  if (cols <= 4) LEMUR_PSI(4);
  if (cols <= 8) LEMUR_PSI(8);
  if (cols <= 16) LEMUR_PSI(16);
#undef LEMUR_PSI
  return (int)cudaErrorInvalidValue;
}
