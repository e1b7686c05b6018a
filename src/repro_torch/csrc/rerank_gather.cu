// Dense-store exact-MaxSim rerank, fp32 tokens or SQ8 codes with per-token
// scales: each query against its own candidates' (Td, d) token slabs.
//
// Replaces: src/repro/kernels/gather_scan.py:rerank_gather_scores
//   (_rerank_fp_kernel, _rerank_sq8_kernel), a scalar-prefetch Pallas kernel
//   with grid (B, k') that DMAs candidate cand[b, c]'s whole (Td, d) slab
//   into VMEM, contracts it with q[b] on the MXU (SQ8: a hi/lo-bf16 split of
//   q against the bf16-widened codes, the per-token scale folded into the
//   score row) and writes the masked max-sum; the (B, k', Td) masks and
//   scales are gathered in XLA beforehand.
//
// Bound on the H100: near both bounds for fp32, operations for SQ8.  A
// candidate costs Tq x Td x d multiply-adds (327 K at Tq = 32, Td = 80,
// d = 128) against Td x d x 4 bytes of fp32 tokens (40 KB): 16 operations a
// byte, beside the card's 20 (67 TFLOP/s over 3.35 TB/s).  SQ8 codes are a
// quarter of the bytes (d + 5 a token with the scale and the mask bit), so
// the multiply-adds bound it.
//
// Design: the paged rerank's shape (rerank.cuh) over a dense store.  A
// block owns one query b and kCandPerBlock of its candidates, one warp a
// candidate at a time; q[b] is staged once per block in shared memory,
// transposed to (d, Tq).  The warp walks the candidate's slab 16 token rows
// at a time: it reads the 16 mask bytes (and scales) of the tile at their
// source (no per-call copy of the (m, Td) mask or scales), skips a tile
// with no valid token, and otherwise copies the tile's rows into its
// shared-memory slot with 16-byte loads (SQ8: 16 codes a load, widened to
// fp32).  Lane t then computes query token t's 16 dots from registers,
// multiplies each by its token's scale (SQ8), and folds the valid tokens
// into its running max; a slab's last tile may be short (Td need not be a
// multiple of 16).  The masked sum over the query tokens ends the
// candidate.  Numerics: the fp32 dot of q with the (widened) row, times the
// scale, as the CPU oracle computes it; the sum order differs, so results
// agree to fp32 rounding.  A -1 candidate is clamped to doc 0 (the caller
// masks it); a candidate with no valid token scores Tq_valid x NEG.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kCandPerBlock = 32;
constexpr int kTile = 16;  // token rows staged at a time

// The tile's rows [0, rows) of D values each, contiguous at src, into the
// warp's fp32 slot.
__device__ __forceinline__ void load_tile(float* slot, const float* src, int rows, int D,
                                          int lane) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(slot);
  for (int i = lane; i < rows * D / 4; i += 32) d[i] = __ldg(s + i);
}

__device__ __forceinline__ void load_tile(float* slot, const int8_t* src, int rows, int D,
                                          int lane) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int i = lane; i < rows * D / 16; i += 32) {
    const uint4 v = __ldg(s + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    float4* d = reinterpret_cast<float4*>(slot + (size_t)i * 16);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      d[j] = make_float4((float)(int8_t)(w[j] & 0xff), (float)(int8_t)((w[j] >> 8) & 0xff),
                         (float)(int8_t)((w[j] >> 16) & 0xff), (float)(int8_t)(w[j] >> 24));
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rerank_gather_kernel(const float* __restrict__ q, const uint8_t* __restrict__ q_mask,
                     const int* __restrict__ cand, const T* __restrict__ tokens,
                     const uint8_t* __restrict__ doc_mask, const float* __restrict__ scales,
                     float* __restrict__ out, int Tq, int D, int kp, int Td, int m) {
  extern __shared__ __align__(16) float sm[];
  float* qT = sm;                                         // D x Tq
  float* slots = qT + ((size_t)D * Tq + 3) / 4 * 4;       // kWarps x kTile x D
  float* best = slots + (size_t)kWarps * kTile * D;       // kWarps x Tq
  float* rs = best + (size_t)kWarps * Tq;                 // kWarps x kTile scales

  const int b = blockIdx.y;
  const float* qb = q + (size_t)b * Tq * D;
  for (int i = threadIdx.x; i < Tq * D; i += kWarps * 32)
    qT[(size_t)(i % D) * Tq + i / D] = qb[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* pg = slots + (size_t)warp * kTile * D;
  float* mx = best + (size_t)warp * Tq;
  float* sc = rs + warp * kTile;
  const int c0 = blockIdx.x * kCandPerBlock;
  const int c1 = min(c0 + kCandPerBlock, kp);
  for (int ci = c0 + warp; ci < c1; ci += kWarps) {
    int c = cand[(size_t)b * kp + ci];
    c = c < 0 ? 0 : (c >= m ? m - 1 : c);
    const size_t row0 = (size_t)c * Td;
    for (int t = lane; t < Tq; t += 32) mx[t] = LEMUR_NEG;
    for (int j = 0; j < Td; j += kTile) {
      const int rows = min(kTile, Td - j);
      const bool ok = lane < rows && doc_mask[row0 + j + lane] != 0;
      const unsigned valid = __ballot_sync(0xffffffffu, ok);
      if (valid == 0u) continue;                           // warp-uniform
      __syncwarp();
      if (lane < rows) sc[lane] = scales != nullptr ? scales[row0 + j + lane] : 1.f;
      load_tile(pg, tokens + (row0 + j) * D, rows, D, lane);
      __syncwarp();
      for (int t = lane; t < Tq; t += 32) {
        float acc[kTile];
#pragma unroll
        for (int s = 0; s < kTile; ++s) acc[s] = 0.f;
        for (int k = 0; k < D; k += 4) {
          const float q0 = qT[(size_t)(k + 0) * Tq + t];
          const float q1 = qT[(size_t)(k + 1) * Tq + t];
          const float q2 = qT[(size_t)(k + 2) * Tq + t];
          const float q3 = qT[(size_t)(k + 3) * Tq + t];
#pragma unroll
          for (int s = 0; s < kTile; ++s) {   // rows past a short tile are not folded
            const float4 p = *reinterpret_cast<const float4*>(pg + s * D + k);
            acc[s] = fmaf(q0, p.x, acc[s]);
            acc[s] = fmaf(q1, p.y, acc[s]);
            acc[s] = fmaf(q2, p.z, acc[s]);
            acc[s] = fmaf(q3, p.w, acc[s]);
          }
        }
        float mv = mx[t];
#pragma unroll
        for (int s = 0; s < kTile; ++s)
          if ((valid >> s) & 1u) mv = fmaxf(mv, scales != nullptr ? acc[s] * sc[s] : acc[s]);
        mx[t] = mv;
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

template <typename T>
int launch(const void* q, const void* q_mask, const void* cand, const void* tokens,
           const void* doc_mask, const void* scales, void* out, int B, int Tq, int D, int kp,
           int Td, int m, void* stream) {
  const size_t smem = (((size_t)D * Tq + 3) / 4 * 4 + (size_t)kWarps * kTile * D +
                       (size_t)kWarps * Tq + (size_t)kWarps * kTile) * sizeof(float);
  cudaError_t err = allow_smem(rerank_gather_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((kp + kCandPerBlock - 1) / kCandPerBlock), (unsigned)B);
  rerank_gather_kernel<T><<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const uint8_t*)q_mask, (const int*)cand, (const T*)tokens,
      (const uint8_t*)doc_mask, (const float*)scales, (float*)out, Tq, D, kp, Td, m);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Tq, D) fp32; q_mask (B, Tq) bool; cand (B, kp) int32; tokens (m,
// Td, D) fp32 (D % 4 == 0); doc_mask (m, Td) bool.  out (B, kp) fp32.
extern "C" int rerank_gather_fp32(const void* q, const void* q_mask, const void* cand,
                                  const void* tokens, const void* doc_mask, void* out, int B,
                                  int Tq, int D, int kp, int Td, int m, void* stream) {
  return launch<float>(q, q_mask, cand, tokens, doc_mask, nullptr, out, B, Tq, D, kp, Td, m,
                       stream);
}

// As rerank_gather_fp32 over int8 codes (m, Td, D) (D % 16 == 0) with
// per-token scales (m, Td) fp32.
extern "C" int rerank_gather_sq8(const void* q, const void* q_mask, const void* cand,
                                 const void* codes, const void* doc_mask, const void* scales,
                                 void* out, int B, int Tq, int D, int kp, int Td, int m,
                                 void* stream) {
  return launch<int8_t>(q, q_mask, cand, codes, doc_mask, scales, out, B, Tq, D, kp, Td, m,
                        stream);
}
