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
// Design (rerank.cuh, shared with the compressed pages' rerank): a block
// owns one query b and kCandPerBlock of its candidates, a warp a candidate
// at a time, walking its page-table row; each page's 16 x d fp32 tokens are
// copied into the warp's shared-memory slot with 16-byte loads, and lane t
// keeps query token t's running max over the candidate's valid positions.
// Any d: a width off whole float4s is copied into a padded slot, and widths
// or query lengths past the block's shared memory take the wide walk
// (rerank.cuh); any B.
#include "rerank.cuh"

namespace {

// fp32 pages: a page is copied as it is (VEC: D % 4 == 0, whole float4s; else
// a value at a time into a slot padded to whole float4s, rerank.cuh).
template <bool VEC>
struct Fp32Pages {
  const float* tok_pages;
  static constexpr bool kPadded = !VEC;
  static size_t smem_floats(int) { return 0; }
  __device__ void stage(float*, int) const {}
  __device__ void load(float* pg, long long pid, int D, int lane, const float*) const {
    if constexpr (VEC) {
      const float4* src = reinterpret_cast<const float4*>(tok_pages + pid * kPage * D);
      float4* dst = reinterpret_cast<float4*>(pg);
      for (int i = lane; i < kPage * D / 4; i += 32) dst[i] = __ldg(src + i);
    } else {
      const float* src = tok_pages + pid * kPage * D;
      const int Ds = rerank_stride(D);
      for (int i = lane; i < kPage * Ds; i += 32) {
        const int s = i / Ds, k = i - s * Ds;
        pg[i] = k < D ? __ldg(src + s * D + k) : 0.f;
      }
    }
  }
  __device__ void load_chunk(float* pg, long long pid, int k0, int kn, int D, int lane) const {
    const float* src = tok_pages + pid * kPage * D + k0;
    for (int i = lane; i < kPage * kn; i += 32) {
      const int s = i / kn, k = i - s * kn;
      pg[s * kWideDims + k] = __ldg(src + (size_t)s * D + k);
    }
  }
};

}  // namespace

extern "C" int rerank_paged_scores(const void* q, const void* q_mask, const void* cand,
                                   const void* tok_pages, const void* page_table,
                                   const void* n_tokens, void* out, int B, int Tq,
                                   int D, int kp, int pmax, int C, long long n_pages,
                                   void* stream) {
  if (D % 4 == 0)
    return launch_rerank_paged(Fp32Pages<true>{(const float*)tok_pages}, q, q_mask, cand,
                               page_table, n_tokens, out, B, Tq, D, kp, pmax, C, n_pages,
                               stream);
  return launch_rerank_paged(Fp32Pages<false>{(const float*)tok_pages}, q, q_mask, cand,
                             page_table, n_tokens, out, B, Tq, D, kp, pmax, C, n_pages,
                             stream);
}
