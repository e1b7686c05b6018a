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
// Bound on the H100: tensor-core operations, unless few candidates repeat.
// A candidate costs Tq_valid x Td_valid x d multiply-adds (276 K at Tq =
// 32, 67.4 valid of Td = 80, d = 128): 3 TF32 products of that for fp32
// tokens, 2 for SQ8 codes (exact in TF32), at 495 TFLOP/s: 3.3 ms (fp32)
// and 2.2 ms (SQ8) for 256 queries x 4,096 candidates, against 8.1 ms on
// the CUDA cores.  Each distinct candidate's valid rows are read once at
// best (SQ8: d + 5 bytes a token with its scale and mask bit; fp32: 4 d +
// 1): 2.8 ms if every candidate of the 256 x 4,096 is distinct.
//
// Design: the MaxSim body of maxsim_tc.cuh.  q[b]'s split image (tc_image:
// Tq tokens in tiles of N = 32, 64 or 128, the smallest that holds Tq, or
// rounds of 128) is wgmma's N operand, resident in the block's shared
// memory while it walks a run of 128 of b's candidates, 8 at a time (a
// consumer warp a candidate, 16 rows a wgmma, split in registers or, for
// SQ8, widened exactly).  Where a token row is whole 16-byte units (d % 4
// fp32, d % 16 SQ8) the producer warps bring each 16-row slice of a
// candidate's slab, from its first valid row to its last, with one bulk
// copy, and read its mask bytes and scales at their source (no per-call
// copy of the (m, Td) arrays); other widths take the per-thread cp.async
// path.  Epilogue: the scale times each dot, masked rows at NEG, the max
// over the candidate's rows in registers, then the sum over b's valid
// query tokens.  A -1 candidate is clamped to doc 0 (the caller masks it);
// a candidate with no valid token scores Tq_valid x NEG; duplicated
// candidates score alike to the bit.  Two launches: the image, then the
// product.
#include "maxsim_tc.cuh"

namespace {

constexpr int kRoundsPerBlock = 16;   // 128 candidates a block

template <typename T, int N>
int launch(const void* q, const void* q_mask, const void* cand, const void* tokens,
           const void* doc_mask, const void* scales, void* out, void* img, int B, int Tq,
           int D, int kp, int Td, int m, cudaStream_t stream) {
  int err = launch_tc_image<N>((const float*)q, (float*)img, B, Tq, D, stream);
  if (err != 0) return err;
  MxArgs a{};
  a.img = (const float*)img;
  a.tok = tokens;
  a.mask = (const uint8_t*)doc_mask;
  a.scales = (const float*)scales;
  a.out = (float*)out;
  a.D = D;
  a.Tr = Td;
  a.NT = (Tq + N - 1) / N;
  a.items = m;
  a.groups = B;
  a.rounds = (kp + kMxWarps - 1) / kMxWarps;
  a.runs = (a.rounds + kRoundsPerBlock - 1) / kRoundsPerBlock;
  a.cand = (const int*)cand;
  a.q_mask = (const uint8_t*)q_mask;
  a.Tq = Tq;
  a.kp = kp;
  return launch_maxsim_tc<T, N, kMxRerank>(a, stream);
}

template <typename T>
int launch_width(int N, const void* q, const void* q_mask, const void* cand,
                 const void* tokens, const void* doc_mask, const void* scales, void* out,
                 void* img, int B, int Tq, int D, int kp, int Td, int m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N == 32)
    return launch<T, 32>(q, q_mask, cand, tokens, doc_mask, scales, out, img, B, Tq, D, kp, Td,
                         m, s);
  if (N == 64)
    return launch<T, 64>(q, q_mask, cand, tokens, doc_mask, scales, out, img, B, Tq, D, kp, Td,
                         m, s);
  if (N == 128)
    return launch<T, 128>(q, q_mask, cand, tokens, doc_mask, scales, out, img, B, Tq, D, kp,
                          Td, m, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, Tq, D) fp32; q_mask (B, Tq) bool; cand (B, kp) int32; tokens (m,
// Td, D) fp32; doc_mask (m, Td) bool -> out (B, kp) fp32.  N: the query
// tile, 32, 64 or 128; img: scratch for q's image (B x ceil(Tq / N) x
// ceil(D / 32) x 64 N floats).
extern "C" int rerank_gather_fp32(const void* q, const void* q_mask, const void* cand,
                                  const void* tokens, const void* doc_mask, void* out,
                                  void* img, int B, int Tq, int D, int kp, int Td, int m,
                                  int N, void* stream) {
  return launch_width<float>(N, q, q_mask, cand, tokens, doc_mask, nullptr, out, img, B, Tq,
                             D, kp, Td, m, stream);
}

// As rerank_gather_fp32 over int8 codes (m, Td, D) with per-token scales
// (m, Td) fp32.
extern "C" int rerank_gather_sq8(const void* q, const void* q_mask, const void* cand,
                                 const void* codes, const void* doc_mask, const void* scales,
                                 void* out, void* img, int B, int Tq, int D, int kp, int Td,
                                 int m, int N, void* stream) {
  return launch_width<int8_t>(N, q, q_mask, cand, codes, doc_mask, scales, out, img, B, Tq,
                              D, kp, Td, m, stream);
}
