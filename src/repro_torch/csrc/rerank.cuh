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
// D) (fills them, by the whole block), load(slot, pid, D, lane, tables)
// (one page into a warp's slot, by the warp) and load_chunk(slot, pid, k0,
// kn, D, lane) (dims k0 .. k0 + kn of the page's tokens, rows kWideDims
// apart, from its tables in device memory, by the warp: the wide walk).
// A policy with kPadded takes a D that is not whole float4s: its slot's
// token rows are rerank_stride(D) floats apart, D rounded up, and it
// writes 0 in the pad dims (q's pad rows are 0 too), so the dot loop runs
// over whole float4s.
// Without kPadded the rows are D apart (D % 4 == 0), the code as it was:
// the padded stride in every instantiation cost the residual rerank a
// fifth of its time on the served shape (chip_smoke.py: 11.3-11.4 ms
// against 9.3, one H100).
//
// Widths whose q (d x Tq) and slots (4 x 16 x d) do not fit a block's
// shared memory (d above about 600 at Tq = 32, Tq above about 380 at d =
// 128) take the wide walk instead, chosen at launch (WIDE, a template
// argument, so the served shape keeps its instructions): the warp brings
// the page kWideDims dims at a time (the policy's load_chunk, from its
// tables in device memory), lane t keeps query token t's 16 partial dots
// in registers across the chunks, reading q[b, t] from device memory
// (cached), and takes the max after the last chunk; Tq above 32 goes in
// rounds of 32 tokens a lane, the page's chunks brought again for each
// round unless the page is one chunk.  Blocks are (query, 32 candidates)
// pairs on one grid axis, the query slower, so any B launches.
#pragma once

#include "common.cuh"

constexpr int kRerankWarps = 4;
constexpr int kCandPerBlock = 32;
constexpr int kPage = 16;  // TOKENS_PER_PAGE
constexpr int kWideDims = 128;  // dims a chunk of the wide walk

__host__ __device__ inline int rerank_stride(int D) { return (D + 3) / 4 * 4; }

// The wide walk (see above): a block's warps, each a candidate at a time.
template <class Pages>
__device__ __forceinline__ void rerank_paged_wide(
    const float* __restrict__ q, const uint8_t* __restrict__ q_mask,
    const int* __restrict__ cand, const Pages& pages, const int* __restrict__ page_table,
    const int* __restrict__ n_tokens, float* __restrict__ out, int b, int tile, int Tq, int D,
    int kp, int pmax, int C, long long n_pages, float* sm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* pg = sm + (size_t)warp * kPage * kWideDims;                   // the page's chunk
  float* mx = sm + (size_t)kRerankWarps * kPage * kWideDims + (size_t)warp * Tq;
  const float* qb = q + (size_t)b * Tq * D;
  const int c0 = tile * kCandPerBlock;
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
      const int valid = min(kPage, nt - j * kPage);
      for (int t0 = 0; t0 < Tq; t0 += 32) {
        const int t = t0 + lane;
        float acc[kPage];
#pragma unroll
        for (int s = 0; s < kPage; ++s) acc[s] = 0.f;
        for (int k0 = 0; k0 < D; k0 += kWideDims) {
          const int kn = min(kWideDims, D - k0);
          if (t0 == 0 || D > kWideDims) {      // else the page's one chunk is in the slot
            __syncwarp();
            pages.load_chunk(pg, pid, k0, kn, D, lane);
            __syncwarp();
          }
          if (t < Tq) {
            const float* qr = qb + (size_t)t * D + k0;
            for (int k = 0; k < kn; ++k) {
              const float qv = __ldg(qr + k);
#pragma unroll
              for (int s = 0; s < kPage; ++s) acc[s] = fmaf(qv, pg[s * kWideDims + k], acc[s]);
            }
          }
        }
        if (t < Tq) {
          float m = mx[t];
#pragma unroll
          for (int s = 0; s < kPage; ++s)
            if (s < valid) m = fmaxf(m, acc[s]);
          mx[t] = m;
        }
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

template <class Pages, bool WIDE>
__global__ void __launch_bounds__(kRerankWarps * 32)
rerank_paged_kernel(const float* __restrict__ q, const uint8_t* __restrict__ q_mask,
                    const int* __restrict__ cand, Pages pages,
                    const int* __restrict__ page_table, const int* __restrict__ n_tokens,
                    float* __restrict__ out, int Tq, int D, int kp, int pmax, int C,
                    long long n_pages, int ktiles) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x / ktiles, tile = blockIdx.x - b * ktiles;
  if constexpr (WIDE) {
    rerank_paged_wide(q, q_mask, cand, pages, page_table, n_tokens, out, b, tile, Tq, D, kp,
                      pmax, C, n_pages, sm);
    return;
  }
  const int Ds = Pages::kPadded ? rerank_stride(D) : D;
  float* qT = sm;                                         // Ds x Tq, rows past D 0
  float* slots = qT + ((size_t)Ds * Tq + 3) / 4 * 4;      // kRerankWarps x kPage x Ds
  float* best = slots + (size_t)kRerankWarps * kPage * Ds; // kRerankWarps x Tq
  float* tables = best + (size_t)kRerankWarps * Tq;       // the policy's

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
  const int c0 = tile * kCandPerBlock;
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
  const int ktiles = (kp + kCandPerBlock - 1) / kCandPerBlock;
  const long long grid = (long long)ktiles * B;
  if (grid == 0) return (int)cudaSuccess;
  if (grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const size_t Ds = Pages::kPadded ? rerank_stride(D) : D;
  const size_t smem = ((Ds * Tq + 3) / 4 * 4 + (size_t)kRerankWarps * kPage * Ds +
                       (size_t)kRerankWarps * Tq + Pages::smem_floats(D)) * sizeof(float);
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return (int)err;
  const bool wide = smem > (size_t)optin;
  const size_t smem_w = ((size_t)kRerankWarps * kPage * kWideDims + (size_t)kRerankWarps * Tq) *
                        sizeof(float);
  auto kernel = wide ? rerank_paged_kernel<Pages, true> : rerank_paged_kernel<Pages, false>;
  err = allow_smem(kernel, wide ? smem_w : smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, kRerankWarps * 32, wide ? smem_w : smem, (cudaStream_t)stream>>>(
      (const float*)q, (const uint8_t*)q_mask, (const int*)cand, pages,
      (const int*)page_table, (const int*)n_tokens, (float*)out, Tq, D, kp, pmax, C,
      n_pages, ktiles);
  return (int)cudaGetLastError();
}
