// Paged exact-MaxSim rerank.
//
// Replaces: src/repro/kernels/gather_scan.py:rerank_paged_scores
//   (_rerank_paged_fp_kernel), a Pallas kernel with grid (B, k', pmax) that
//   DMAs one 16-token page per grid step (page ids scalar-prefetched to SMEM)
//   and carries a per-query-token running max in VMEM across the pmax steps.
//
// Bound on the H100: device-memory bytes.  Each candidate brings its
// n_tokens valid rows of d fp32 from ceil(n_tokens/16) pages of 16 x d
// (8 KB at d = 128), about 7.6 GB of distinct rows for the default route's
// 256 x 1,024 candidates (2.3 ms at 3.35 TB/s), and each valid row costs
// Tq x d multiply-adds (4 K at Tq = 32): 2.0 ms on the CUDA cores at 67
// TFLOP/s, at the bytes' edge, or 0.83 ms on the tensor cores at 3xTF32
// (3 products at 495 TFLOP/s).
//
// Design (the served widths): the MaxSim body of maxsim_tc.cuh, a client
// beside token MaxSim, the dense rerank and the paged residual rerank.  An
// item is a candidate, a slice one of its 16-token pages; q's split image
// is wgmma's N operand (tiles of 32, 64 or 128 query tokens), resident in
// the block while it walks 512 of the query's candidates, 8 at a time:
//  - a launch before the product (rerank_paged_prep_kernel) gathers each
//    candidate's token count (0 for -1 or an id past the slots) and page
//    ids (clamped to the pool, -1 past ceil(n_tokens / 16)), so that the
//    producer warps read them a round ahead without a chain of loads;
//  - the producer warps bring each page's valid rows straight into the
//    consumer warp's slot with bulk copies on the slot's mbarrier, up to
//    three slots a consumer warp (the 32 KB image and 8 x 3 slots of 8 KB
//    fill the block's shared memory at d = 128): no staging, no decode;
//  - the consumer warps split the rows into TF32 pieces and multiply (3xTF32,
//    as the dense rerank); the epilogue masks positions >= n_tokens, takes
//    the max over the candidate's rows and the masked sum over the query's
//    valid tokens.
// Scores are within ref.TF32_SPLIT_RTOL of the fp64 dot; ref.tf32_split_rerank
// over the gathered pages emulates the arithmetic.  A -1 candidate (or one
// past the slots, or a doc of no token) scores Tq_valid x NEG, summed in
// the CUDA-core kernel's order (the same bits on either path); duplicated
// candidates score alike to the bit.  Three launches: q's image, the prep,
// the product.  The wrapper records the path a launch took
// (rerank_paged_scores.last_path).
//
// Other widths (a layout that does not fit a block's shared memory: d or
// Tq past the resident image, or fewer than two slots a consumer warp; d
// off whole float4s, or pages not on 16 bytes) take the CUDA-core kernel,
// chosen at launch (rerank_paged_plan): rerank.cuh's body, shared with the
// compressed pages' rerank: a block owns one query b and kCandPerBlock of
// its candidates, a warp a candidate at a time, walking its page-table row;
// each page's 16 x d fp32 tokens are copied into the warp's shared-memory
// slot with 16-byte loads, and lane t keeps query token t's running max
// over the candidate's valid positions.  A width off whole float4s is
// copied into a padded slot, and widths or query lengths past the block's
// shared memory take the wide walk (rerank.cuh); any B.
#include "maxsim_tc.cuh"
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

// The launch before the product: for each of the nb queries' candidates i
// (flat b * kp + i), its token count (0 for -1 or an id past the slots) and
// page ids, clamped to the pool, -1 past ceil(n / 16).
__global__ void rerank_paged_prep_kernel(const int* __restrict__ cand,
                                         const int* __restrict__ page_table,
                                         const int* __restrict__ n_tokens, int* __restrict__ gpt,
                                         int* __restrict__ gnt, long long total, int pmax, int C,
                                         long long n_pages) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / pmax;
    const int j = (int)(e - i * pmax);
    const int c = cand[i];
    const bool real = c >= 0 && c < C;
    const int nt = real ? n_tokens[c] : 0;
    int pid = -1;
    if (j < (nt + kPage - 1) / kPage) {
      const long long v = page_table[(size_t)c * pmax + j];
      pid = (int)(v < 0 ? 0 : (v >= n_pages ? n_pages - 1 : v));
    }
    gpt[e] = pid;
    if (j == 0) gnt[i] = nt;
  }
}

namespace {

constexpr int kPgRoundsPerBlock = 64;    // 512 candidates a block
constexpr size_t kPgScratchBytes = 1 << 28;   // the image and page ids a call holds at a time

MxResArgs pg_args(int B, int Tq, int D, int kp, int pmax, int N) {
  MxResArgs a{};
  a.D = D;
  a.Tr = kPage;
  a.NT = (Tq + N - 1) / N;
  a.groups = B;
  a.rounds = (kp + kMxWarps - 1) / kMxWarps;
  a.runs = (a.rounds + kPgRoundsPerBlock - 1) / kPgRoundsPerBlock;
  a.Tq = Tq;
  a.kp = kp;
  a.pmax = pmax;
  return a;
}

size_t pg_layout(MxResArgs& a, int N, int optin) {
  if (N == 32) return mx_pg_layout<32>(a, optin);
  if (N == 64) return mx_pg_layout<64>(a, optin);
  if (N == 128) return mx_pg_layout<128>(a, optin);
  return 0;
}

}  // namespace

// How rerank_paged_scores runs: plan[0] = N, the tensor cores' query tile
// (32, 64 or 128), or 0 for the CUDA-core kernel; plan[1] = the queries a
// chunk (the scratch of rerank_paged_scores holds that many).
extern "C" int rerank_paged_plan(int B, int Tq, int D, int kp, int pmax, const void* tok_pages,
                                 int* plan) {
  plan[0] = 0;
  plan[1] = B;
  const int N = Tq <= 32 ? 32 : (Tq <= 64 ? 64 : 128);
  if (Tq < 1 || kp < 1 || pmax < 1 || D % 4 || reinterpret_cast<uintptr_t>(tok_pages) % 16)
    return (int)cudaSuccess;
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return (int)err;
  MxResArgs a = pg_args(B, Tq, D, kp, pmax, N);
  if (pg_layout(a, N, optin) == 0) return (int)cudaSuccess;
  const size_t per_q = ((size_t)a.NT * a.KC * 2 * N * kTcK + (size_t)kp * (pmax + 1)) * 4;
  const size_t bc = kPgScratchBytes / per_q;
  plan[0] = N;
  plan[1] = (int)(bc < 1 ? 1 : (bc < (size_t)B ? bc : (size_t)B));
  return (int)cudaSuccess;
}

// q (B, Tq, D) fp32; q_mask (B, Tq) bytes; cand (B, kp) int32; tok_pages
// (n_pages, 16, D) fp32; page_table (C, pmax) int32; n_tokens (C,) int32 ->
// out (B, kp) fp32.  N and Bc: rerank_paged_plan's; with N > 0 the scratch
// holds Bc queries: img (tc_image: Bc x ceil(Tq / N) x ceil(D / 32) x 64 N
// floats), gpt (Bc, kp, pmax) and gnt (Bc, kp) int32.
extern "C" int rerank_paged_scores(const void* q, const void* q_mask, const void* cand,
                                   const void* tok_pages, const void* page_table,
                                   const void* n_tokens, void* out, void* img, void* gpt,
                                   void* gnt, int B, int Tq, int D, int kp, int pmax, int C,
                                   long long n_pages, int N, int Bc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N > 0) {
    int optin = 0;
    cudaError_t e = smem_optin(&optin);
    if (e != cudaSuccess) return (int)e;
    if (Bc < 1) return (int)cudaErrorInvalidValue;
    for (int b0 = 0; b0 < B; b0 += Bc) {
      const int nb = B - b0 < Bc ? B - b0 : Bc;
      const float* qb = (const float*)q + (size_t)b0 * Tq * D;
      MxResArgs a = pg_args(nb, Tq, D, kp, pmax, N);
      const size_t smem = pg_layout(a, N, optin);
      if (smem == 0) return (int)cudaErrorInvalidValue;
      int err = N == 32 ? launch_tc_image<32>(qb, (float*)img, nb, Tq, D, st)
              : N == 64 ? launch_tc_image<64>(qb, (float*)img, nb, Tq, D, st)
                        : launch_tc_image<128>(qb, (float*)img, nb, Tq, D, st);
      if (err != 0) return err;
      const long long total = (long long)nb * kp * pmax;
      const long long blocks = (total + 255) / 256 < 8192 ? (total + 255) / 256 : 8192;
      rerank_paged_prep_kernel<<<(unsigned)blocks, 256, 0, st>>>(
          (const int*)cand + (size_t)b0 * kp, (const int*)page_table, (const int*)n_tokens,
          (int*)gpt, (int*)gnt, total, pmax, C, n_pages);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
      a.img = (const float*)img;
      a.tok = tok_pages;
      a.out = (float*)out + (size_t)b0 * kp;
      a.q_mask = (const uint8_t*)q_mask + (size_t)b0 * Tq;
      a.gpt = (const int*)gpt;
      a.gnt = (const int*)gnt;
      err = N == 32 ? launch_maxsim_tc_pg<32>(a, smem, st)
          : N == 64 ? launch_maxsim_tc_pg<64>(a, smem, st)
                    : launch_maxsim_tc_pg<128>(a, smem, st);
      if (err != 0) return err;
    }
    return (int)cudaSuccess;
  }
  if (D % 4 == 0)
    return launch_rerank_paged(Fp32Pages<true>{(const float*)tok_pages}, q, q_mask, cand,
                               page_table, n_tokens, out, B, Tq, D, kp, pmax, C, n_pages,
                               stream);
  return launch_rerank_paged(Fp32Pages<false>{(const float*)tok_pages}, q, q_mask, cand,
                             page_table, n_tokens, out, B, Tq, D, kp, pmax, C, n_pages,
                             stream);
}
