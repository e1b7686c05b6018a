// The paged exact-MaxSim rerank's body, shared by rerank_paged.cu (fp32
// pages) and rerank_paged_res.cu (compressed pages); each file's header
// says what it replaces and what bounds it.
//
// A block owns one query b and kCandPerBlock of its candidates, one warp
// per candidate at a time.  q[b] is staged once per block in shared memory,
// transposed to (d, Tq) so that lane t reading token t is conflict-free.
// For each page of the candidate (the block reads the page table row
// itself; page ids < 0 are clamped to 0 before loading, as on the TPU), the
// warp puts the page's 16 x d fp32 tokens into its own shared-memory slot
// (the Pages policy: a copy, or a decode), then lane t computes the 16 dots
// of query token t against the page from registers (page values are read
// as warp-wide broadcasts) and folds positions < n_tokens into its running
// max.  Positions >= n_tokens are masked by position, never by page id.
// Unlike the TPU grid, the walk stops after ceil(n_tokens/16) pages: the
// pages skipped are fully masked, so the result is unchanged.  A candidate
// with n_tokens 0 (pads, the -1 id) keeps every running max at NEG and
// scores the finite Tq_valid * NEG; the wrapper masks it.
//
// A Pages policy has smem_floats(D) (its block-wide tables), stage(tables,
// D) (fills them, by the whole block) and load(slot, pid, D, lane, tables)
// (one page into a warp's slot, by the warp).  A policy with kPadded
// takes a D that is not whole float4s: its slot's token rows are
// rerank_stride(D) floats apart, D rounded up, and it writes 0 in the pad
// dims (q's pad rows are 0 too), so the dot loop runs over whole float4s.
// Without kPadded the rows are D apart (D % 4 == 0), the code as it was:
// the padded stride in every instantiation cost the residual rerank a
// fifth of its time on the served shape (chip_smoke.py: 11.3-11.4 ms
// against 9.3, one H100).
#pragma once

#include "common.cuh"

constexpr int kRerankWarps = 4;
constexpr int kCandPerBlock = 32;
constexpr int kPage = 16;  // TOKENS_PER_PAGE

__host__ __device__ inline int rerank_stride(int D) { return (D + 3) / 4 * 4; }

template <class Pages>
__global__ void __launch_bounds__(kRerankWarps * 32)
rerank_paged_kernel(const float* __restrict__ q, const uint8_t* __restrict__ q_mask,
                    const int* __restrict__ cand, Pages pages,
                    const int* __restrict__ page_table, const int* __restrict__ n_tokens,
                    float* __restrict__ out, int Tq, int D, int kp, int pmax, int C,
                    long long n_pages) {
  extern __shared__ __align__(16) float sm[];
  const int Ds = Pages::kPadded ? rerank_stride(D) : D;
  float* qT = sm;                                         // Ds x Tq, rows past D 0
  float* slots = qT + ((size_t)Ds * Tq + 3) / 4 * 4;      // kRerankWarps x kPage x Ds
  float* best = slots + (size_t)kRerankWarps * kPage * Ds; // kRerankWarps x Tq
  float* tables = best + (size_t)kRerankWarps * Tq;       // the policy's

  const int b = blockIdx.y;
  const float* qb = q + (size_t)b * Tq * D;
  if constexpr (Pages::kPadded) {
    for (int i = threadIdx.x; i < Tq * Ds; i += kRerankWarps * 32) {
      const int t = i / Ds, k = i % Ds;
      qT[(size_t)k * Tq + t] = k < D ? qb[(size_t)t * D + k] : 0.f;
    }
  } else {
    for (int i = threadIdx.x; i < Tq * D; i += kRerankWarps * 32)
      qT[(size_t)(i % D) * Tq + i / D] = qb[i];
  }
  pages.stage(tables, D);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* pg = slots + (size_t)warp * kPage * Ds;
  float* mx = best + (size_t)warp * Tq;
  const int c0 = blockIdx.x * kCandPerBlock;
  const int c1 = min(c0 + kCandPerBlock, kp);
  for (int ci = c0 + warp; ci < c1; ci += kRerankWarps) {
    const int c = cand[(size_t)b * kp + ci];
    const bool real = c >= 0 && c < C;
    const int nt = real ? n_tokens[c] : 0;
    const int npg = min((nt + kPage - 1) / kPage, pmax);
    for (int t = lane; t < Tq; t += 32) mx[t] = LEMUR_NEG;
    for (int j = 0; j < npg; ++j) {
      long long pid = page_table[(size_t)c * pmax + j];
      pid = pid < 0 ? 0 : (pid >= n_pages ? n_pages - 1 : pid);
      __syncwarp();
      pages.load(pg, pid, D, lane, tables);
      __syncwarp();
      const int valid = min(kPage, nt - j * kPage);
      for (int t = lane; t < Tq; t += 32) {
        float acc[kPage];
#pragma unroll
        for (int s = 0; s < kPage; ++s) acc[s] = 0.f;
        for (int k = 0; k < Ds; k += 4) {
          const float q0 = qT[(size_t)(k + 0) * Tq + t];
          const float q1 = qT[(size_t)(k + 1) * Tq + t];
          const float q2 = qT[(size_t)(k + 2) * Tq + t];
          const float q3 = qT[(size_t)(k + 3) * Tq + t];
#pragma unroll
          for (int s = 0; s < kPage; ++s) {
            const float4 p = *reinterpret_cast<const float4*>(pg + s * Ds + k);
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

template <class Pages>
int launch_rerank_paged(Pages pages, const void* q, const void* q_mask, const void* cand,
                        const void* page_table, const void* n_tokens, void* out, int B,
                        int Tq, int D, int kp, int pmax, int C, long long n_pages,
                        void* stream) {
  const size_t Ds = Pages::kPadded ? rerank_stride(D) : D;
  const size_t smem = ((Ds * Tq + 3) / 4 * 4 + (size_t)kRerankWarps * kPage * Ds +
                       (size_t)kRerankWarps * Tq + Pages::smem_floats(D)) * sizeof(float);
  cudaError_t err = allow_smem(rerank_paged_kernel<Pages>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((kp + kCandPerBlock - 1) / kCandPerBlock), (unsigned)B);
  rerank_paged_kernel<Pages><<<grid, kRerankWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const uint8_t*)q_mask, (const int*)cand, pages,
      (const int*)page_table, (const int*)n_tokens, (float*)out, Tq, D, kp, pmax, C,
      n_pages);
  return (int)cudaGetLastError();
}
