// Paged exact-MaxSim rerank.
//
// Replaces: src/repro/kernels/gather_scan.py:rerank_paged_scores
//   (_rerank_paged_fp_kernel), a Pallas kernel with grid (B, k', pmax) that
//   DMAs one 16-token page per grid step (page ids scalar-prefetched to SMEM)
//   and carries a per-query-token running max in VMEM across the pmax steps.
//
// Bound on the H100: about even.  Each candidate brings ceil(n_tokens/16)
// pages of 16 x d fp32 (8 KB at d = 128) and each page costs Tq x 16 x d
// multiply-adds (64 K at Tq = 32): 16 fp32 operations per byte, against the
// card's 67 TFLOP/s / 3.35 TB/s = 20.  So the kernel must both stream pages
// at memory rate and keep the CUDA cores busy.
//
// Design: a block owns one query b and kCandPerBlock of its candidates, one
// warp per candidate at a time.  q[b] is staged once per block in shared
// memory, transposed to (d, Tq) so that lane t reading token t is
// conflict-free.  For each page of the candidate (the block reads the page
// table row itself; page ids < 0 are clamped to 0 before loading, as on the
// TPU), the warp copies the 16 x d page into its own shared-memory slot with
// 16-byte loads, then lane t computes the 16 dots of query token t against
// the page from registers (page values are read as warp-wide broadcasts) and
// folds positions < n_tokens into its running max.  Positions >= n_tokens
// are masked by position, never by page id.  Unlike the TPU grid, the walk
// stops after ceil(n_tokens/16) pages: the pages skipped are fully masked,
// so the result is unchanged.  A candidate with n_tokens 0 (pads, the -1
// id) keeps every running max at NEG and scores the finite Tq_valid * NEG;
// the wrapper masks it.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kCandPerBlock = 32;
constexpr int kPage = 16;  // TOKENS_PER_PAGE

__global__ void __launch_bounds__(kWarps * 32)
rerank_paged_kernel(const float* __restrict__ q, const uint8_t* __restrict__ q_mask,
                    const int* __restrict__ cand, const float* __restrict__ tok_pages,
                    const int* __restrict__ page_table, const int* __restrict__ n_tokens,
                    float* __restrict__ out, int Tq, int D, int kp, int pmax, int C,
                    long long n_pages) {
  extern __shared__ __align__(16) float sm[];
  float* qT = sm;                                    // D x Tq
  float* pages = qT + ((size_t)D * Tq + 3) / 4 * 4;  // kWarps x kPage x D
  float* best = pages + (size_t)kWarps * kPage * D;  // kWarps x Tq

  const int b = blockIdx.y;
  const float* qb = q + (size_t)b * Tq * D;
  for (int i = threadIdx.x; i < Tq * D; i += kWarps * 32)
    qT[(size_t)(i % D) * Tq + i / D] = qb[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* pg = pages + (size_t)warp * kPage * D;
  float* mx = best + (size_t)warp * Tq;
  const int c0 = blockIdx.x * kCandPerBlock;
  const int c1 = min(c0 + kCandPerBlock, kp);
  for (int ci = c0 + warp; ci < c1; ci += kWarps) {
    const int c = cand[(size_t)b * kp + ci];
    const bool real = c >= 0 && c < C;
    const int nt = real ? n_tokens[c] : 0;
    const int npg = min((nt + kPage - 1) / kPage, pmax);
    for (int t = lane; t < Tq; t += 32) mx[t] = LEMUR_NEG;
    for (int j = 0; j < npg; ++j) {
      long long pid = page_table[(size_t)c * pmax + j];
      pid = pid < 0 ? 0 : (pid >= n_pages ? n_pages - 1 : pid);
      const float4* src = reinterpret_cast<const float4*>(tok_pages + pid * kPage * D);
      float4* dst = reinterpret_cast<float4*>(pg);
      __syncwarp();
      for (int i = lane; i < kPage * D / 4; i += 32) dst[i] = __ldg(src + i);
      __syncwarp();
      const int valid = min(kPage, nt - j * kPage);
      for (int t = lane; t < Tq; t += 32) {
        float acc[kPage];
#pragma unroll
        for (int s = 0; s < kPage; ++s) acc[s] = 0.f;
        for (int k = 0; k < D; k += 4) {
          const float q0 = qT[(size_t)(k + 0) * Tq + t];
          const float q1 = qT[(size_t)(k + 1) * Tq + t];
          const float q2 = qT[(size_t)(k + 2) * Tq + t];
          const float q3 = qT[(size_t)(k + 3) * Tq + t];
#pragma unroll
          for (int s = 0; s < kPage; ++s) {
            const float4 p = *reinterpret_cast<const float4*>(pg + s * D + k);
            acc[s] = fmaf(q0, p.x, acc[s]);
            acc[s] = fmaf(q1, p.y, acc[s]);
            acc[s] = fmaf(q2, p.z, acc[s]);
            acc[s] = fmaf(q3, p.w, acc[s]);
          }
        }
        float m = mx[t];
#pragma unroll
        for (int s = 0; s < kPage; ++s)
          if (s < valid) m = fmaxf(m, acc[s]);
        mx[t] = m;
      }
    }
    __syncwarp();
    float sum = 0.f;
    for (int t = lane; t < Tq; t += 32)
      if (q_mask[(size_t)b * Tq + t]) sum += mx[t];
    sum = warp_sum(sum);
    if (lane == 0) out[(size_t)b * kp + ci] = sum;
    __syncwarp();
  }
}

}  // namespace

extern "C" int rerank_paged_scores(const void* q, const void* q_mask, const void* cand,
                                   const void* tok_pages, const void* page_table,
                                   const void* n_tokens, void* out, int B, int Tq,
                                   int D, int kp, int pmax, int C, long long n_pages,
                                   void* stream) {
  const size_t smem = (((size_t)D * Tq + 3) / 4 * 4 + (size_t)kWarps * kPage * D +
                       (size_t)kWarps * Tq) * sizeof(float);
  cudaError_t err = allow_smem(rerank_paged_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((kp + kCandPerBlock - 1) / kCandPerBlock), (unsigned)B);
  rerank_paged_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const uint8_t*)q_mask, (const int*)cand,
      (const float*)tok_pages, (const int*)page_table, (const int*)n_tokens,
      (float*)out, Tq, D, kp, pmax, C, n_pages);
  return (int)cudaGetLastError();
}
