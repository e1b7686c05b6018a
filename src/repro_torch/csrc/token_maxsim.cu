// Token-level MaxSim: out[i, l] = max over valid tokens t of doc l of
// <x[i], docs[l, t]>, and NEG where doc l has no valid token.
//
// Replaces: src/repro/kernels/maxsim.py:token_maxsim (_token_maxsim_kernel),
//   a Pallas kernel with grid (n / 256, m / 64) that views a (64, T, d) docs
//   tile as one (64 T, d) matrix, runs one MXU matmul against a (256, d)
//   x tile and takes a masked max over T.
//
// Bound on the H100: fp32 operations.  Each (query token, valid doc token)
// pair costs d multiply-adds; at the build's shapes (d = 128, a mean of
// 67.4 valid tokens of T = 80) one OLS block of n' = 16,384 tokens against
// 2,048 docs is 579 GFLOP over 226 MB (2,600 operations a byte, against the
// card's 67 TFLOP/s / 3.35 TB/s = 20): 8.6 ms at the CUDA-core peak.
//
// Design: a block owns a tile of 128 query tokens, staged once in shared
// memory (transposed to (d, 128): 64 KB at d = 128), and a run of 32 docs.
// It walks the run 4 docs at a time; for each chunk of 16 token positions
// it stages the 4 x 16 doc tokens in shared memory (transposed to (d, 64))
// together with their mask bits, and each of the 256 threads forms an 8 x 4
// register tile of fp32 FMA dots: 8 query tokens against 4 tokens of one
// doc, read as float4 from shared memory (3 shared loads for 32 FMAs).  A
// staged doc value feeds 128 query tokens, so staging costs 1/128 of the
// FMAs.  The dots of valid tokens fold into a running max per (query
// token, doc) kept in registers (8 a thread), starting at NEG; after the
// doc's last chunk the 4 threads sharing a doc combine their maxima with
// two warp shuffles and one writes the 8 results.  A chunk whose 64
// positions are all masked is skipped (the result is unchanged); masked
// positions are never read from device memory.  Row tiles vary fastest over
// the grid, so the blocks in flight share a doc run and read it from L2.
// No tensor cores: the sums stay fp32 like the plain version's.
#include "common.cuh"

namespace {

constexpr int kRows = 128;      // query tokens a block
constexpr int kDocs = 4;        // docs a chunk
constexpr int kChunk = 16;      // token positions a doc a chunk
constexpr int kCols = kDocs * kChunk;
constexpr int kRun = 32;        // docs a block
constexpr int kThreads = 256;   // 16 x 16, an 8 x 4 tile each
constexpr int kLdx = kRows + 4; // shared row strides, float4-aligned
constexpr int kLdd = kCols + 4;

__global__ void __launch_bounds__(kThreads)
token_maxsim_kernel(const float* __restrict__ x, const float* __restrict__ docs,
                    const uint8_t* __restrict__ mask, float* __restrict__ out,
                    int n, int m, int T, int D, int n_runs) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                          // D x kLdx: x tile, transposed
  float* ds = xs + (size_t)D * kLdx;       // D x kLdd: doc chunk, transposed
  int* mk = reinterpret_cast<int*>(ds + (size_t)D * kLdd);  // kCols mask bits

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // rows ty*8.., tokens tx*4..
  const long long row0 = (long long)blockIdx.x * kRows;
  // staging walks (column, k) pairs kThreads apart without dividing per element
  const int c_first = tid / D, k_first = tid - c_first * D;
  const int c_step = kThreads / D, k_step = kThreads - c_step * D;

  for (int c = c_first, k = k_first; c < kRows;) {
    xs[(size_t)k * kLdx + c] = row0 + c < n ? x[(size_t)(row0 + c) * D + k] : 0.f;
    c += c_step;
    k += k_step;
    if (k >= D) k -= D, ++c;
  }

  for (int run = blockIdx.y; run < n_runs; run += gridDim.y) {
    const int run_end = min(run * kRun + kRun, m);
    for (int l0 = run * kRun; l0 < run_end; l0 += kDocs) {
      float best[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) best[r] = LEMUR_NEG;
      for (int t0 = 0; t0 < T; t0 += kChunk) {
        __syncthreads();  // the previous chunk's readers are done
        int any = 0;
        if (tid < kCols) {
          const int l = l0 + tid / kChunk, t = t0 + tid % kChunk;
          any = l < run_end && t < T && mask[(size_t)l * T + t];
          mk[tid] = any;
        }
        if (!__syncthreads_or(any)) continue;
#pragma unroll 4
        for (int c = c_first, k = k_first; c < kCols;) {
          const int l = l0 + c / kChunk, t = t0 + c % kChunk;
          ds[(size_t)k * kLdd + c] = mk[c] ? docs[((size_t)l * T + t) * D + k] : 0.f;
          c += c_step;
          k += k_step;
          if (k >= D) k -= D, ++c;
        }
        __syncthreads();
        float acc[8][4];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
        for (int k = 0; k < D; ++k) {
          const float4 a0 = *reinterpret_cast<const float4*>(xs + (size_t)k * kLdx + ty * 8);
          const float4 a1 = *reinterpret_cast<const float4*>(xs + (size_t)k * kLdx + ty * 8 + 4);
          const float4 b = *reinterpret_cast<const float4*>(ds + (size_t)k * kLdd + tx * 4);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (mk[tx * 4 + c]) {
#pragma unroll
            for (int r = 0; r < 8; ++r) best[r] = fmaxf(best[r], acc[r][c]);
          }
        }
      }
      // the 4 threads of a doc are lanes 4q..4q+3 of one warp
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        best[r] = fmaxf(best[r], __shfl_xor_sync(0xffffffffu, best[r], 1));
        best[r] = fmaxf(best[r], __shfl_xor_sync(0xffffffffu, best[r], 2));
      }
      const int l = l0 + (tx >> 2);
      if ((tx & 3) == 0 && l < run_end) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const long long row = row0 + ty * 8 + r;
          if (row < n) out[(size_t)row * m + l] = best[r];
        }
      }
    }
  }
}

}  // namespace

extern "C" int token_maxsim(const void* x, const void* docs, const void* mask, void* out,
                            int n, int m, int T, int D, void* stream) {
  const size_t smem = (size_t)D * (kLdx + kLdd) * sizeof(float) + kCols * sizeof(int);
  cudaError_t err = allow_smem(token_maxsim_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_runs = (m + kRun - 1) / kRun;
  const dim3 grid((unsigned)((n + kRows - 1) / kRows),
                  (unsigned)(n_runs < 65535 ? n_runs : 65535));
  token_maxsim_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)docs, (const uint8_t*)mask, (float*)out, n, m, T, D,
      n_runs);
  return (int)cudaGetLastError();
}
