// psi(x) = LN(GELU_tanh(x W' + b)) over one segment of rows, by a whole
// block of kPsiThreads threads: the body of the fused psi kernel
// (fused_psi_pool.cu, where the design is described), shared with the
// one-launch query kernel (query_fused.cu), which pools each query's tokens
// with it.  The same code in both gives the same bits for the same query.
#pragma once

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
// tid + kPsiThreads * c of d').  sm: psi_smem_floats(D, Dp) floats.
template <int C>
__device__ __forceinline__ void psi_segment(
    const float* __restrict__ x, const uint8_t* __restrict__ mask,
    const float* __restrict__ W, const float* __restrict__ bias,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float* __restrict__ out, float (&pooled)[C], int seg0, int seg_len,
    int n_rows, int D, int Dp, bool pool, float eps, float* sm) {
  constexpr int kThreads = kPsiThreads, kRows = kPsiRows;
  float* xs = sm;                       // kRows x D
  float* hs = xs + kRows * D;           // kRows x Dp
  float* stats = hs + (size_t)kRows * Dp;  // kRows x (mean, 1/std)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int r0 = 0; r0 < seg_len; r0 += kRows) {
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int r = i / D, row = seg0 + r0 + r;
      xs[i] = (r0 + r < seg_len && row < n_rows) ? x[(size_t)row * D + i % D] : 0.f;
    }
    __syncthreads();

    float acc[kRows][C];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
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
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = tid + c * kThreads;
      if (j < Dp) {
        const float bj = bias[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) hs[(size_t)r * Dp + j] = gelu_tanh(acc[r][c] + bj);
      }
    }
    __syncthreads();

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
    __syncthreads();
  }
}
