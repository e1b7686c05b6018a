// Fused feature encoder psi(x) = LN(GELU_tanh(x W' + b)), with the masked
// query pool sum_t mask_t * psi(x_t) fused in.
//
// Replaces: src/repro/kernels/fused_psi.py:fused_psi (_fused_psi_kernel), a
//   Pallas kernel that keeps a (block_n, d') row tile in VMEM so that the
//   LayerNorm reduction over the full d' stays local.  The JAX serving path
//   computes the pool in jnp (core/model.py:pool_queries); here it runs
//   through this kernel.
//
// Bound on the H100: operations.  A batch of 256 queries x 32 tokens is
// 2 x 8192 x 128 x 2048 = 4.3 GFLOP against about 7 MB of inputs and
// outputs, so the fp32 CUDA-core rate bounds it (no tensor cores: the
// product stays in fp32 FMA, as the reference computes it).
//
// Design: one block per segment of seg_len rows (one query's Tq tokens when
// pooling).  Rows go through in tiles of kRows: the x tile sits in shared
// memory and is read as broadcasts, each thread owns C columns of d'
// (column j = tid + 256 c, coalesced reads of W') and keeps a kRows x C
// register tile of the product.  GELU output for the whole tile is held in
// shared memory (kRows x d' fp32, 64 KB at d' = 2048) so one warp per row
// can take the LayerNorm mean and variance over the full d' (two passes,
// as the reference does).  Then each thread normalises its columns, applies
// gamma and beta, and either writes the row (unpooled form) or adds
// mask_t * y into a per-thread pooled accumulator that is written once per
// segment.  The mask is applied after psi, so a masked token adds 0 even
// though psi(0) != 0.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;  // one warp per row for the statistics

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k0 * (x + 0.044715f * x * x * x)));
}

template <int C>
__global__ void __launch_bounds__(kThreads)
fused_psi_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                 const float* __restrict__ W, const float* __restrict__ bias,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 float* __restrict__ out, int n_rows, int seg_len, int D, int Dp,
                 int pool, float eps) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                       // kRows x D
  float* hs = xs + kRows * D;           // kRows x Dp
  float* stats = hs + (size_t)kRows * Dp;  // kRows x (mean, 1/std)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int seg0 = blockIdx.x * seg_len;
  float pooled[C];
#pragma unroll
  for (int c = 0; c < C; ++c) pooled[c] = 0.f;

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
  if (pool) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = tid + c * kThreads;
      if (j < Dp) out[(size_t)blockIdx.x * Dp + j] = pooled[c];
    }
  }
}

template <int C>
int launch(const float* x, const uint8_t* mask, const float* W, const float* bias,
           const float* gamma, const float* beta, float* out, int n_rows,
           int seg_len, int D, int Dp, int pool, float eps, cudaStream_t stream) {
  const size_t smem = ((size_t)kRows * D + (size_t)kRows * Dp + 2 * kRows) * sizeof(float);
  cudaError_t err = allow_smem(fused_psi_kernel<C>, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_seg = (n_rows + seg_len - 1) / seg_len;
  fused_psi_kernel<C><<<n_seg, kThreads, smem, stream>>>(
      x, mask, W, bias, gamma, beta, out, n_rows, seg_len, D, Dp, pool, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// pool != 0: out is (n_rows / seg_len, Dp), the masked sum of each segment
// (mask may be null: every row counts).  pool == 0: out is (n_rows, Dp).
extern "C" int fused_psi(const void* x, const void* mask, const void* W,
                         const void* bias, const void* gamma, const void* beta,
                         void* out, int n_rows, int seg_len, int D, int Dp,
                         int pool, float eps, void* stream) {
  const int cols = (Dp + kThreads - 1) / kThreads;
  auto* xf = (const float*)x;
  auto* mk = (const uint8_t*)mask;
  auto* Wf = (const float*)W;
  auto* bf = (const float*)bias;
  auto* gf = (const float*)gamma;
  auto* tf = (const float*)beta;
  auto* of = (float*)out;
  auto* st = (cudaStream_t)stream;
  if (cols <= 1) return launch<1>(xf, mk, Wf, bf, gf, tf, of, n_rows, seg_len, D, Dp, pool, eps, st);
  if (cols <= 2) return launch<2>(xf, mk, Wf, bf, gf, tf, of, n_rows, seg_len, D, Dp, pool, eps, st);
  if (cols <= 4) return launch<4>(xf, mk, Wf, bf, gf, tf, of, n_rows, seg_len, D, Dp, pool, eps, st);
  if (cols <= 8) return launch<8>(xf, mk, Wf, bf, gf, tf, of, n_rows, seg_len, D, Dp, pool, eps, st);
  if (cols <= 16) return launch<16>(xf, mk, Wf, bf, gf, tf, of, n_rows, seg_len, D, Dp, pool, eps, st);
  return (int)cudaErrorInvalidValue;  // d' > 4096: the wrapper refuses it first
}
