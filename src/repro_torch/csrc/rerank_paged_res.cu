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
// Bound on the H100: fp32 operations.  A page is 16 int32 ids and 16 x d x
// bits / 8 bytes of codes (1.1 KB at d = 128 and 4 bits, against 8 KB of
// fp32), and still costs Tq x 16 x d multiply-adds (64 K at Tq = 32): about
// 110 operations a byte, far above the card's 20 (67 TFLOP/s over 3.35
// TB/s).  The fp32 rerank, the same arithmetic over eight times the bytes,
// sits near both bounds.
//
// Design: the fp32 rerank's body (rerank.cuh): a block owns one query and
// 32 of its candidates, a warp a candidate at a time, walking its page-table
// row, lane t keeping query token t's running max.  Only a page's arrival
// differs: the warp decodes the page into its shared-memory slot, lane l
// taking dims 4 l .. 4 l + 3 of 8 tokens at a time with their loads in
// flight together (coalesced, each lane on its own bank), each element
// centroid[id][k] + values[k][code] (residual.cuh: one fp32 add, the host
// decoder's bits), then runs the unchanged dot and max loop.  The values
// table, (d, L) = 8 KB at d = 128 and 4 bits, is staged once per block in
// shared memory, level-major; the (ncent, d) centroid table (128 KB at 256
// x 128) is read a row at a time through the read-only cache and stays in
// L2.  Centroid ids are clamped to the table, page ids to the pool.  Widths
// or query lengths past the block's shared memory take rerank.cuh's wide
// walk, decoding a page kWideDims dims at a time from the tables in device
// memory; any B.
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

// q (B, Tq, D) fp32; q_mask (B, Tq) bytes; cand (B, kp) int32; cent_pages
// (n_pages, 16) int32; code_pages (n_pages, 16, D * bits / 8) uint8;
// page_table (C, pmax) int32; n_tokens (C,) int32; centroids (ncent, D) and
// values (D, 2^bits) fp32 -> out (B, kp) fp32.  D * bits / 8 whole bytes;
// bits 2 or 4.
extern "C" int rerank_paged_res_scores(const void* q, const void* q_mask, const void* cand,
                                       const void* cent_pages, const void* code_pages,
                                       const void* page_table, const void* n_tokens,
                                       const void* centroids, const void* values, void* out,
                                       int B, int Tq, int D, int kp, int pmax, int C,
                                       long long n_pages, int ncent, int bits,
                                       void* stream) {
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
