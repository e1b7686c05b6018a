// Paged exact-MaxSim rerank over compressed token pages (centroid-id pages
// plus packed 2/4-bit residual pages), decoded on the card.
//
// Replaces: src/repro/kernels/gather_scan.py:rerank_paged_res_scores
//   (_rerank_paged_res_kernel, residual_decode_onehot), a Pallas kernel with
//   grid (B, k', pmax) that DMAs one page's 16 centroid ids and 16 x d
//   packed codes per grid step, decodes them in VMEM (a select-sum over the
//   levels and a one-hot product with the (ncent, d) centroid table) and
//   carries a per-query-token running max across the pmax steps.
//
// Bound on the H100: operations.  A page is 16 int32 ids and 16 x d x
// bits / 8 bytes of codes (1.1 KB at d = 128 and 4 bits, against 8 KB of
// fp32), and costs Tq x 16 x d multiply-adds (64 K at Tq = 32): about 110
// operations a byte.  On the tensor cores at 3xTF32 (every decoded value is
// an fp32 number, split in two TF32 pieces, as the query) the served shape's
// 1.4e11 operations take 0.83 ms at 495 TFLOP/s (2.0 ms on the CUDA cores).
//
// Design (the served widths): the MaxSim body of maxsim_tc.cuh, a third
// client beside token MaxSim and the dense rerank.  A decoded element is
// centroid[c][k] + values[k][code], so a token's dot with query token t is
// q_t . centroid[c] + q_t . v with v[k] = values[k][code_k]:
//  - a launch before the product (rerank_res_prep_kernel) computes, for
//    each query, the (ncent x Tq) table of q_t . centroid (fp32, one fmaf
//    chain an entry, shared-memory tiles) and gathers each candidate's token
//    count and page ids (clamped to the pool, -1 past ceil(n_tokens / 16)),
//    so the product's producer warps read them without a chain of loads;
//  - the product: q's split image is wgmma's N operand (tiles of 32, 64 or
//    128 query tokens), a page is an item's 16-row slice; the producer
//    warps copy each page's codes and centroid ids into a staging ring and
//    decode the residual part v of its rows into the consumer warp's slot
//    from a values table in shared memory (maxsim_tc.cuh: mx_res_producer),
//    so the consumer warps only split and multiply, as for fp32 tokens;
//    the epilogue adds the centroid part from the table in shared memory,
//    masks positions >= n_tokens, takes the max over the candidate's rows
//    and the masked sum over the query's tokens.
// What bounds it now (kernels/residual_ablation.py, PERF.md): the MaxSim
// body's per-slice work with N = 32 query columns, as for the dense rerank
// (without any page data the product keeps about 70 % of its time), and
// the producers' decode, which overlaps it only in part: two slots a
// consumer warp (the slots, the image, the tables and the staging fill
// the block's shared memory) let a producer run one slice ahead.
// No centroid row is read (a 512-byte row a token would be about 9 GB from
// L2 a call at the served shape).  The score differs from the dot with
// the host decoder's tokens by fp32 rounding (the centroid part is summed
// apart), within ref.TF32_SPLIT_RTOL of the fp64 dot; ref.tf32_split_rerank_res
// emulates the arithmetic.  A -1 candidate (or one past the slots) has no
// token and scores Tq_valid x NEG, summed in the CUDA-core kernel's order
// (the same bits on either path); duplicated candidates score alike to the
// bit.  Three launches: q's image, the prep, the product.  The wrapper
// records the path a launch took (rerank_paged_res_scores.last_path).
//
// Other widths (a layout that does not fit a block's shared memory: d or
// Tq past the resident image, a large centroid table, d off the slot's
// pitch at R = 2; or codes not on 16 bytes) take the CUDA-core kernel,
// chosen at launch (rerank_paged_res_plan): the fp32 rerank's body
// (rerank.cuh), a warp a candidate decoding each page into its shared-memory
// slot, lane l taking dims 4 l .. 4 l + 3 of 8 tokens at a time with their
// loads in flight together, each element centroid[id][k] + values[k][code]
// (residual.cuh: one fp32 add, the host decoder's bits), then lane t the
// dots of query token t.  The values table, (d, L) = 8 KB at d = 128 and 4
// bits, is staged once per block in shared memory, level-major; the
// centroid table is read a row at a time through the read-only cache.
// Centroid ids are clamped to the table, page ids to the pool.  Widths or
// query lengths past the block's shared memory take rerank.cuh's wide walk,
// decoding a page kWideDims dims at a time from the tables in device
// memory; any B.
#include "maxsim_tc.cuh"
#include "rerank.cuh"
#include "residual.cuh"

namespace {

// VEC: D % 4 == 0, a page decoded four dims at a time; else a value at a
// time into a padded slot (rerank.cuh: kPadded)
template <int BITS, bool VEC>
struct ResPages {
  static constexpr bool kPadded = !VEC;
  const int* cent_pages;        // (P, kPage)
  const uint8_t* code_pages;    // (P, kPage, D / per)
  const float* centroids;       // (ncent, D)
  const float* values;          // (D, L)
  int ncent;

  // vs holds values level-major, a level's row padded after every 32 dims
  // (and to whole banks), so that lane l reading dims 4 l .. 4 l + 3 hits
  // its own bank whatever the codes
  static __host__ __device__ int vs_stride(int D) { return (D + D / 32 + 31) / 32 * 32; }
  static __device__ int vs_col(int k) { return k + (k >> 5); }
  static size_t smem_floats(int D) { return (size_t)ResCodes<BITS>::kLevels * vs_stride(D); }

  __device__ void stage(float* vs, int D) const {
    constexpr int L = ResCodes<BITS>::kLevels;
    for (int i = threadIdx.x; i < L * D; i += blockDim.x)
      vs[(i / D) * vs_stride(D) + vs_col(i % D)] = values[(size_t)(i % D) * L + i / D];
  }

  // Lane l decodes dims 4 l .. 4 l + 3 (and 4 (l + 32) .., past d = 128) of
  // the page's 16 tokens, 8 tokens at a time with all their loads in flight
  // before any is used: a float4 of the token's centroid row (512 contiguous
  // bytes a warp) and the 2 or 1 bytes of codes (contiguous too); the decoded
  // float4 goes to the warp's slot.  The 16 centroid ids arrive in one load
  // and are broadcast by shuffles.  A D that is not a multiple of 4 (even
  // at 4 bits, as pack_codes takes) is decoded a value at a time instead,
  // the slot's pad dims 0 (rerank.cuh).
  // The wide walk's chunk: dims k0 .. k0 + kn of the page's 16 tokens, a
  // value at a time, the values table read from device memory (cached).
  __device__ void load_chunk(float* pg, long long pid, int k0, int kn, int D, int lane) const {
    using RC = ResCodes<BITS>;
    const int db = D / RC::kPer;
    const uint8_t* src = code_pages + pid * kPage * db;
    const int mine = lane < kPage ? min(max(cent_pages[pid * kPage + lane], 0), ncent - 1) : 0;
    for (int s = 0; s < kPage; ++s) {
      const float* crow = centroids + (size_t)__shfl_sync(0xffffffffu, mine, s) * D;
      const uint8_t* row = src + s * db;
      for (int k = lane; k < kn; k += 32) {
        const int kk = k0 + k;
        const int code = RC::code(__ldg(row + kk / RC::kPer), kk % RC::kPer);
        pg[s * kWideDims + k] =
            res_decode(__ldg(crow + kk), __ldg(values + (size_t)kk * RC::kLevels + code));
      }
    }
  }

  __device__ void load(float* pg, long long pid, int D, int lane, const float* vs) const {
    using RC = ResCodes<BITS>;
    constexpr int kBatch = 8;
    const int db = D / RC::kPer, stride = vs_stride(D);
    const uint8_t* src = code_pages + pid * kPage * db;
    const int mine = lane < kPage ? min(max(cent_pages[pid * kPage + lane], 0), ncent - 1) : 0;
    if constexpr (!VEC) {
      const int Ds = rerank_stride(D);
      for (int s = 0; s < kPage; ++s) {
        const float* crow = centroids + (size_t)__shfl_sync(0xffffffffu, mine, s) * D;
        const uint8_t* row = src + s * db;
        for (int k = lane; k < Ds; k += 32) {
          float o = 0.f;
          if (k < D)
            o = res_decode(__ldg(crow + k),
                           vs[RC::code(__ldg(row + k / RC::kPer), k % RC::kPer) * stride +
                              vs_col(k)]);
          pg[s * Ds + k] = o;
        }
      }
      return;
    }
    for (int s0 = 0; s0 < kPage; s0 += kBatch) {
      const float* crow[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        crow[i] = centroids + (size_t)__shfl_sync(0xffffffffu, mine, s0 + i) * D;
      for (int k4 = lane; k4 < D / 4; k4 += 32) {
        float4 c[kBatch];
        uint32_t code4[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          c[i] = __ldg(reinterpret_cast<const float4*>(crow[i]) + k4);
          const uint8_t* row = src + (s0 + i) * db;
          code4[i] = BITS == 4 ? __ldg(reinterpret_cast<const uint16_t*>(row) + k4)
                               : __ldg(row + k4);
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int k = 4 * k4;
          float4 o;
          o.x = res_decode(c[i].x, vs[RC::code(code4[i], 0) * stride + vs_col(k + 0)]);
          o.y = res_decode(c[i].y, vs[RC::code(code4[i], 1) * stride + vs_col(k + 1)]);
          o.z = res_decode(c[i].z, vs[RC::code(code4[i], 2) * stride + vs_col(k + 2)]);
          o.w = res_decode(c[i].w, vs[RC::code(code4[i], 3) * stride + vs_col(k + 3)]);
          *reinterpret_cast<float4*>(pg + (s0 + i) * D + k) = o;
        }
      }
    }
  }
};

}  // namespace

// The launch before the product, a block a query b: qc[b][c][t] = q[b, t] .
// centroids[c] (an fmaf chain over d in order; 0 for t >= Tq up to qcs),
// and for each of b's candidates i its token count (0 for -1 or an id past
// the slots) and page ids, clamped to the pool, -1 past ceil(n / 16).  The
// table: q[b] in shared memory, the centroids 64 rows x 32 dims at a time,
// thread (c, g) keeping 8 of token group g's sums of centroid c in
// registers (q read as broadcasts, the centroid tile's rows padded off
// each other's banks).
constexpr int kPrepCents = 64, kPrepDims = 32, kPrepThreads = 256;
constexpr int kPrepGroups = kPrepThreads / kPrepCents;   // token groups
constexpr int kPrepTokens = 8 * kPrepGroups;             // tokens a pass

inline size_t res_prep_smem(int Tq, int D) {
  return ((size_t)Tq * D + kPrepCents * (kPrepDims + 1)) * sizeof(float);
}

__global__ void __launch_bounds__(kPrepThreads)
rerank_res_prep_kernel(const float* __restrict__ q, const int* __restrict__ cand,
                       const int* __restrict__ page_table, const int* __restrict__ n_tokens,
                       const float* __restrict__ centroids, float* __restrict__ qc,
                       int* __restrict__ gpt, int* __restrict__ gnt, int Tq, int D, int kp,
                       int pmax, int C, long long n_pages, int ncent, int qcs) {
  extern __shared__ __align__(16) float ps[];
  float* qs = ps;                                   // q[b], (Tq, D)
  float* cs = ps + (size_t)Tq * D;                  // (kPrepCents, kPrepDims + 1)
  const int b = blockIdx.x, tid = threadIdx.x;
  const int cl = tid % kPrepCents, tg = tid / kPrepCents;
  for (int i = tid; i < Tq * D; i += kPrepThreads) qs[i] = q[(size_t)b * Tq * D + i];
  float* qo = qc + (size_t)b * ncent * qcs;
  for (int c0 = 0; c0 < ncent; c0 += kPrepCents) {
    for (int t0 = 0; t0 < qcs; t0 += kPrepTokens) {
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < D; k0 += kPrepDims) {
        __syncthreads();                            // (q is in; the last tile is read)
        for (int i = tid; i < kPrepCents * kPrepDims; i += kPrepThreads) {
          const int c = c0 + i / kPrepDims, k = k0 + i % kPrepDims;
          cs[(i / kPrepDims) * (kPrepDims + 1) + i % kPrepDims] =
              c < ncent && k < D ? __ldg(centroids + (size_t)c * D + k) : 0.f;
        }
        __syncthreads();
        const int kn = min(kPrepDims, D - k0);
        for (int kk = 0; kk < kn; ++kk) {
          const float cv = cs[cl * (kPrepDims + 1) + kk];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int t = t0 + tg + kPrepGroups * i;
            if (t < Tq) acc[i] = fmaf(qs[(size_t)t * D + k0 + kk], cv, acc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = t0 + tg + kPrepGroups * i;
        if (c0 + cl < ncent && t < qcs) qo[(size_t)(c0 + cl) * qcs + t] = acc[i];
      }
    }
  }
  for (int e = tid; e < kp * pmax; e += kPrepThreads) {
    const int i = e / pmax, j = e % pmax;
    const int c = cand[(size_t)b * kp + i];
    const bool real = c >= 0 && c < C;
    const int nt = real ? n_tokens[c] : 0;
    int pid = -1;
    if (j < (nt + kPage - 1) / kPage) {
      const long long v = page_table[(size_t)c * pmax + j];
      pid = (int)(v < 0 ? 0 : (v >= n_pages ? n_pages - 1 : v));
    }
    gpt[(size_t)b * kp * pmax + e] = pid;
    if (j == 0) gnt[(size_t)b * kp + i] = nt;
  }
}

namespace {

constexpr int kResRoundsPerBlock = 64;   // 512 candidates a block
constexpr size_t kResQcBytes = 1 << 28;  // the q . centroid tables a call holds at a time

MxResArgs res_args(int B, int Tq, int D, int kp, int pmax, int ncent, int bits, int N) {
  MxResArgs a{};
  a.D = D;
  a.Tr = kPage;
  a.NT = (Tq + N - 1) / N;
  a.groups = B;
  a.rounds = (kp + kMxWarps - 1) / kMxWarps;
  a.runs = (a.rounds + kResRoundsPerBlock - 1) / kResRoundsPerBlock;
  a.Tq = Tq;
  a.kp = kp;
  a.pmax = pmax;
  a.ncent = ncent;
  a.db = D * bits / 8;
  return a;
}

size_t res_layout(MxResArgs& a, int N, int bits, int optin) {
  if (N == 32) return mx_res_layout<32>(a, bits, optin);
  if (N == 64) return mx_res_layout<64>(a, bits, optin);
  if (N == 128) return mx_res_layout<128>(a, bits, optin);
  return 0;
}

template <int N>
int launch_res_tc(MxResArgs a, size_t smem, int bits, cudaStream_t stream) {
  if (bits == 4) return launch_maxsim_tc_res<N, 4>(a, smem, stream);
  return launch_maxsim_tc_res<N, 2>(a, smem, stream);
}

}  // namespace

// How rerank_paged_res_scores runs: plan[0] = N, the tensor cores' query
// tile (32, 64 or 128), or 0 for the CUDA-core kernel; plan[1] = the
// queries a chunk (the scratch of rerank_paged_res_scores holds that many).
extern "C" int rerank_paged_res_plan(int B, int Tq, int D, int kp, int pmax, int ncent, int bits,
                                     const void* cent_pages, const void* code_pages,
                                     int* plan) {
  plan[0] = 0;
  plan[1] = B;
  const int N = Tq <= 32 ? 32 : (Tq <= 64 ? 64 : (Tq <= 128 ? 128 : 0));
  if (N == 0 || Tq < 1 || kp < 1 || pmax < 1 || ncent < 1 || (bits != 2 && bits != 4) ||
      reinterpret_cast<uintptr_t>(cent_pages) % 16 || reinterpret_cast<uintptr_t>(code_pages) % 16)
    return (int)cudaSuccess;
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return (int)err;
  MxResArgs a = res_args(B, Tq, D, kp, pmax, ncent, bits, N);
  if (res_layout(a, N, bits, optin) == 0) return (int)cudaSuccess;
  const size_t per_q = (size_t)ncent * (N + 2) * 4;
  const size_t bc = kResQcBytes / per_q;
  plan[0] = N;
  plan[1] = (int)(bc < 1 ? 1 : (bc < (size_t)B ? bc : (size_t)B));
  return (int)cudaSuccess;
}

// q (B, Tq, D) fp32; q_mask (B, Tq) bytes; cand (B, kp) int32; cent_pages
// (n_pages, 16) int32; code_pages (n_pages, 16, D * bits / 8) uint8;
// page_table (C, pmax) int32; n_tokens (C,) int32; centroids (ncent, D) and
// values (D, 2^bits) fp32 -> out (B, kp) fp32.  D * bits / 8 whole bytes;
// bits 2 or 4.  N and Bc: rerank_paged_res_plan's; with N > 0 the scratch
// holds Bc queries: img (tc_image: Bc x ceil(Tq / N) x ceil(D / 32) x 64 N
// floats), qc (Bc, ncent, N + 2) fp32, gpt (Bc, kp, pmax) and gnt (Bc, kp)
// int32.
extern "C" int rerank_paged_res_scores(const void* q, const void* q_mask, const void* cand,
                                       const void* cent_pages, const void* code_pages,
                                       const void* page_table, const void* n_tokens,
                                       const void* centroids, const void* values, void* out,
                                       void* img, void* qc, void* gpt, void* gnt,
                                       int B, int Tq, int D, int kp, int pmax, int C,
                                       long long n_pages, int ncent, int bits, int N, int Bc,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N > 0) {
    int optin = 0;
    cudaError_t e = smem_optin(&optin);
    if (e != cudaSuccess) return (int)e;
    if (Bc < 1) return (int)cudaErrorInvalidValue;
    for (int b0 = 0; b0 < B; b0 += Bc) {
      const int nb = B - b0 < Bc ? B - b0 : Bc;
      const float* qb = (const float*)q + (size_t)b0 * Tq * D;
      MxResArgs a = res_args(nb, Tq, D, kp, pmax, ncent, bits, N);
      const size_t smem = res_layout(a, N, bits, optin);
      if (smem == 0) return (int)cudaErrorInvalidValue;
      int err = N == 32 ? launch_tc_image<32>(qb, (float*)img, nb, Tq, D, st)
              : N == 64 ? launch_tc_image<64>(qb, (float*)img, nb, Tq, D, st)
                        : launch_tc_image<128>(qb, (float*)img, nb, Tq, D, st);
      if (err != 0) return err;
      const size_t psmem = res_prep_smem(Tq, D);
      err = (int)allow_smem(rerank_res_prep_kernel, psmem);
      if (err != 0) return err;
      rerank_res_prep_kernel<<<nb, kPrepThreads, psmem, st>>>(
          qb, (const int*)cand + (size_t)b0 * kp, (const int*)page_table, (const int*)n_tokens,
          (const float*)centroids, (float*)qc, (int*)gpt, (int*)gnt, Tq, D, kp, pmax, C,
          n_pages, ncent, a.qcs);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
      a.img = (const float*)img;
      a.out = (float*)out + (size_t)b0 * kp;
      a.q_mask = (const uint8_t*)q_mask + (size_t)b0 * Tq;
      a.gpt = (const int*)gpt;
      a.gnt = (const int*)gnt;
      a.cent_pages = (const int*)cent_pages;
      a.code_pages = (const uint8_t*)code_pages;
      a.qc = (const float*)qc;
      a.values = (const float*)values;
      err = N == 32 ? launch_res_tc<32>(a, smem, bits, st)
          : N == 64 ? launch_res_tc<64>(a, smem, bits, st)
                    : launch_res_tc<128>(a, smem, bits, st);
      if (err != 0) return err;
    }
    return (int)cudaSuccess;
  }
#define LEMUR_RES_RERANK(BITS, VEC)                                                      \
  return launch_rerank_paged(                                                            \
      ResPages<BITS, VEC>{(const int*)cent_pages, (const uint8_t*)code_pages,            \
                          (const float*)centroids, (const float*)values, ncent},         \
      q, q_mask, cand, page_table, n_tokens, out, B, Tq, D, kp, pmax, C, n_pages, stream)
  if (bits == 4 && D % 4 == 0) LEMUR_RES_RERANK(4, true);
  if (bits == 4) LEMUR_RES_RERANK(4, false);
  if (bits == 2) LEMUR_RES_RERANK(2, true);   // whole bytes at 2 bits: D % 4 == 0
#undef LEMUR_RES_RERANK
  return (int)cudaErrorInvalidValue;
}
