// The one-launch first stages: query_fused (IVF probe scan + top-k' of
// pooled queries, fp32 and SQ8 lists), query_fused_res (the same over
// residual lists) and mips_topk (dense latent scan + top-k', fp32 and SQ8
// rows).  The pooled latent comes in: the route's probe selection pooled
// each query already (the psi-pool kernel, fused_psi_pool.cu), so a search
// pools once.
//
// Replaces: src/repro/kernels/query_fused.py:query_fused
//   (_query_fused_fp_kernel, _query_fused_sq8_kernel, _pool_psi, _merge_topk),
//   :query_fused_res (_query_fused_res_kernel) and :mips_topk
//   (_mips_topk_fp_kernel, _mips_topk_sq8_kernel).  On the
//   TPU both carry a (1, k') top-k in VMEM scratch across the sequential grid
//   axis (probes, or row tiles) and merge each step's strip into it with the
//   carried entries first, so that earlier flat positions win ties.
//
// Hopper has no sequential grid axis and its blocks cannot hold a carry
// of any k' (227 KB of shared memory a block), so the port splits each
// first stage in two: a kernel writes every probed slot's score to a
// per-query strip in device memory (pads -inf), and select.cuh's
// topk_select takes each query's exact top-k' by the key (score desc, flat
// position asc), the stable flat top-k's order, whatever k'.  On the
// served index this is faster than a list kept in shared memory and folded
// a chunk at a time (the earlier design, capped at k' = 2,048): query_fused
// over SQ8 lists 3.66 ms against 4.04-4.07 at k' = 1,024, the same ids
// (chip_smoke.py, one H100; PERF.md).
//
// query_fused.  Bound on the H100: device-memory bytes, as the probe scan
// (about one operation per byte of the lists).  Design: the IVF scan by
// list and the selection, one after another on the stream (four CUDA
// launches a call): the scan is ivf_probe_scan's own body
// (scan_grouped.cuh: the (b, p) pairs grouped by list, each live row staged
// once for a chunk of up to 8 of its readers), written straight into the
// (B, P cap) strip, pads and out-of-range probes -inf; the selection is
// finish_strip's.  So query_fused equals psi-pool + ivf_probe_scan + the
// stable flat top-k' bit for bit, and reads each live row once a chunk of
// its readers instead of once a query: 1.87-1.92 ms over SQ8 lists at the
// served shape with its own psi-pool (0.35 of it), where the
// one-block-a-query kernel it replaced took 3.72-3.80 (fp32 lists, 256 of
// them: 1.87-1.93 against 8.27-8.35, a reduced index whose lists have about
// 8 times the served readers), on one NVIDIA H100 80GB HBM3 at a 700.00 W
// power limit (PERF.md §6, row 7).
//
// query_fused_res.  Bound on the H100: the lookups' instructions, as the
// residual probe scan's (ivf_probe_res_scan.cu: about 4 instructions a
// code, a floor of about 0.8 ms at the served shape against 0.26 ms for the
// bytes).  One block a query, walking every slot of its lists, waits on
// loads (the pad slots' ids alone cost a third of its time: PERF.md §6).
// Design: kQfrBlocks = 2 blocks a query (1, 4 and 8 measured slower:
// kernels/residual_ablation.py), each reading the query's pooled latent
// into shared memory; block r takes, in every probed list, the live slots
// whose rank among the list's live slots is r mod 2 (residual.cuh:
// res_scan; pads are not read, and block r writes -inf at the pad slots =
// r mod 2), and scores them against one table of q[k] values[k][l] that
// serves every list, plus q . c a probe, with the residual scan's own code,
// so its scores are the residual scan's bit for bit; the strip and the
// selection as query_fused's.  What bounds it now: the lookups (about a
// third of its time) and the walk's loads.
//
// mips_topk.  Bound on the H100: tensor-core operations (tc_scan.cuh: 3
// TF32 products of 2 B m d', 5.1 ms at B = 256 over 800k live fp32 rows of
// d' = 2048; 2 for SQ8 rows), against 2 ms for the fp32 rows' bytes.  The
// product runs on the tensor cores (tc_scan.cuh), and no pass keeps a
// per-query list, so k' is not capped:
//  - small inputs (fewer than 128 k' rows; the wrapper's FILTER_MIN_ROWS):
//    the product stores the (B, m) scores, 256 queries at a time, and
//    topk_select takes each query's top-k';
//  - large ones: the product over every 32nd row (a row stride, no copy)
//    stores the sample's scores, and topk_select's bound mode takes each
//    query's k'-th: a score the final k'-th cannot fall below, since the
//    filter scores those rows to the bit.  The filtered pass, the same
//    product, appends every (row, score) at or above the bound to the
//    query's candidates; topk_select finishes.  A query with more
//    candidates than its buffer sets a flag and the wrapper runs the small
//    inputs' path over every row.
// CUDA launches a call: the q image (tc_q_image), then 2 a query chunk
// (small), or 4 and a memset (large).
#include "residual.cuh"
#include "scan_grouped.cuh"
#include "select.cuh"
#include "tc_scan.cuh"

namespace {

// The selection: the exact top-kp of each query's strip (pads -inf),
// positions mapped to ids.
int finish_strip(float* strips, sel_key_t* scratch, float* out_s, int* out_i,
                 const int* probe, const int* ids, int B, int P, int cap, int kp,
                 cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  SelArgs a{};
  a.s = strips;
  a.ld = (long long)P * cap;
  a.n = P * cap;
  a.kp = kp;
  a.scratch = scratch;
  a.out_s = out_s;
  a.out_i = out_i;
  a.probe = probe;
  a.ids = ids;
  a.P = P;
  a.lcap = cap;
  return launch_topk_select(a, B, stream);
}

template <typename T>
int launch_query_fused(const void* latent, const void* probe, const void* ids,
                       const void* vecs, const void* scales, void* out_s, void* out_i,
                       void* strips, void* scratch, void* scan_scratch, int B, int Dp, int P,
                       int cap, int nlist, int kp, void* stream) {
  if (kp < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = launch_ivf_scan<T>((const float*)latent, (const int*)probe, (const int*)ids,
                           (const T*)vecs, (const float*)scales, (float*)strips,
                           (int*)scan_scratch, B, P, cap, Dp, nlist, st);
  if (err != 0) return err;
  return finish_strip((float*)strips, (sel_key_t*)scratch, (float*)out_s, (int*)out_i,
                      (const int*)probe, (const int*)ids, B, P, cap, kp, st);
}

// -------------------------------------------------------------------------
// query_fused_res
// -------------------------------------------------------------------------

constexpr int kQfrBlocks = 2;               // blocks a query

template <int BITS, bool WHOLE>
__global__ void __launch_bounds__(kResThreads, 2)
query_fused_res_kernel(const float* __restrict__ latent, const int* __restrict__ probe,
                       const int* __restrict__ ids, const uint8_t* __restrict__ codes,
                       const float* __restrict__ centroids, const float* __restrict__ values,
                       float* __restrict__ strips, int P, int cap, int Dp, int nlist) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                           // the pooled latent, (Dp,)
  float* work = sm + (Dp + 3) / 4 * 4;      // res_scan's scratch
  const int b = blockIdx.x / kQfrBlocks, rank = blockIdx.x % kQfrBlocks;
  for (int j = threadIdx.x; j < Dp; j += kResThreads) qs[j] = latent[(size_t)b * Dp + j];
  __syncthreads();                          // the latent is in
  res_scan<BITS, WHOLE>(probe + (size_t)b * P, P, 1, kQfrBlocks, rank, qs, ids, codes,
                        centroids, values, strips + (size_t)b * P * cap, cap, Dp, nlist, work);
}

template <int BITS>
int launch_query_fused_res(const void* latent, const void* probe, const void* ids,
                           const void* codes, const void* centroids, const void* values,
                           void* out_s, void* out_i, void* strips, void* scratch, int B,
                           int Dp, int P, int cap, int nlist, int kp, cudaStream_t stream) {
  if (kp < 1 || (long long)B * kQfrBlocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const bool whole = res_whole_words(codes, Dp, BITS);
  const auto kernel = whole ? query_fused_res_kernel<BITS, true>
                            : query_fused_res_kernel<BITS, false>;
  const size_t smem = ((Dp + 3) / 4 * 4 + res_smem_floats(BITS)) * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * kQfrBlocks, kResThreads, smem, stream>>>(
      (const float*)latent, (const int*)probe, (const int*)ids, (const uint8_t*)codes,
      (const float*)centroids, (const float*)values, (float*)strips, P, cap, Dp, nlist);
  return finish_strip((float*)strips, (sel_key_t*)scratch, (float*)out_s, (int*)out_i,
                      (const int*)probe, (const int*)ids, B, P, cap, kp, stream);
}

}  // namespace

// latent (B, Dp) fp32: the pooled queries.  scales == nullptr: fp32 lists;
// else int8 codes with per-slot scales.  Outputs (B, kp) scores and ids.
// Device memory: strips (B, P * cap) fp32 for the probed strip's scores,
// scratch (B, kp) 8-byte keys for the selection and scan_scratch
// ivf_probe_scan_scratch(B, P, nlist) int32 words for the grouping.
extern "C" int query_fused_fp32(const void* latent, const void* probe, const void* ids,
                                const void* vecs, void* out_s, void* out_i, void* strips,
                                void* scratch, void* scan_scratch, int B, int Dp, int P,
                                int cap, int nlist, int kp, void* stream) {
  return launch_query_fused<float>(latent, probe, ids, vecs, nullptr, out_s, out_i, strips,
                                   scratch, scan_scratch, B, Dp, P, cap, nlist, kp, stream);
}

extern "C" int query_fused_sq8(const void* latent, const void* probe, const void* ids,
                               const void* codes, const void* scales, void* out_s, void* out_i,
                               void* strips, void* scratch, void* scan_scratch, int B, int Dp,
                               int P, int cap, int nlist, int kp, void* stream) {
  return launch_query_fused<int8_t>(latent, probe, ids, codes, scales, out_s, out_i, strips,
                                    scratch, scan_scratch, B, Dp, P, cap, nlist, kp, stream);
}

// codes (nlist, cap, Dp * bits / 8) uint8 against each list's own centroid;
// centroids (nlist, Dp), values (Dp, 2^bits) fp32; bits 2 or 4.  Otherwise
// as query_fused_fp32.
extern "C" int query_fused_res(const void* latent, const void* probe, const void* ids,
                               const void* codes, const void* centroids, const void* values,
                               void* out_s, void* out_i, void* strips, void* scratch, int B,
                               int Dp, int P, int cap, int nlist, int kp, int bits,
                               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (bits == 4)
    return launch_query_fused_res<4>(latent, probe, ids, codes, centroids, values, out_s,
                                     out_i, strips, scratch, B, Dp, P, cap, nlist, kp, st);
  if (bits == 2)
    return launch_query_fused_res<2>(latent, probe, ids, codes, centroids, values, out_s,
                                     out_i, strips, scratch, B, Dp, P, cap, nlist, kp, st);
  return (int)cudaErrorInvalidValue;
}


// q (B, D) fp32 -> img, tc_scan.cuh's shared-memory image of q's split
// pieces: ceil(B / 128) x ceil(D / 32) x 8,192 floats.
extern "C" int tc_q_image(const void* q, void* img, int B, int D, void* stream) {
  return launch_tc_q_image((const float*)q, (float*)img, B, D, (cudaStream_t)stream);
}

// The product's store mode: out[b * ldo + r] = q[b] . W[r * rs] (times the
// row's scale, NEG for an invalid row) for the B queries of img and the m
// logical rows r.  W (rows, D) fp32 (scales null) or int8 codes with
// (rows,) scales; valid (rows,) bytes or null.
extern "C" int mips_scan_store(const void* img, const void* W, const void* scales,
                               const void* valid, void* out, long long ldo, int B, int m,
                               int D, int rs, int sq8, void* stream) {
  TcScan a{};
  a.img = (const float*)img;
  a.W = W;
  a.scales = (const float*)scales;
  a.valid = (const uint8_t*)valid;
  a.B = B;
  a.m = m;
  a.D = D;
  a.rs = rs;
  a.out = (float*)out;
  a.ldo = ldo;
  if (sq8) return launch_tc_scan<int8_t, false>(a, (cudaStream_t)stream);
  return launch_tc_scan<float, false>(a, (cudaStream_t)stream);
}

// The filtered pass: thr (B,) each query's bound; cnt (B,) int (zeroed
// here), buf_s / buf_p (B, cap) candidates, the count past cap kept.
extern "C" int mips_scan_filter(const void* img, const void* W, const void* scales,
                                const void* valid, const void* thr, void* cnt, void* buf_s,
                                void* buf_p, int cap, int B, int m, int D, int sq8,
                                void* stream) {
  cudaError_t err = cudaMemsetAsync(cnt, 0, (size_t)B * sizeof(int), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  TcScan a{};
  a.img = (const float*)img;
  a.W = W;
  a.scales = (const float*)scales;
  a.valid = (const uint8_t*)valid;
  a.B = B;
  a.m = m;
  a.D = D;
  a.rs = 1;
  a.thr = (const float*)thr;
  a.cnt = (int*)cnt;
  a.buf_s = (float*)buf_s;
  a.buf_p = (int*)buf_p;
  a.cap = cap;
  if (sq8) return launch_tc_scan<int8_t, true>(a, (cudaStream_t)stream);
  return launch_tc_scan<float, true>(a, (cudaStream_t)stream);
}

// topk_select over B queries' candidates: scores s (B, ld) with positions
// p (B, ld) (null: the column), n each or cnt (B,) (null: n; past cap the
// query sets *overflow and writes nothing) -> out_s / out_i (B, kp), or
// with bound (B,) non-null only each query's kp-th score.  scratch (B, kp)
// 8-byte keys.
extern "C" int topk_select(const void* s, const void* p, long long ld, const void* cnt, int n,
                           int cap, void* scratch, void* out_s, void* out_i, void* bound,
                           void* overflow, int B, int kp, void* stream) {
  if (kp < 1) return (int)cudaErrorInvalidValue;
  SelArgs a{};
  a.s = (const float*)s;
  a.p = (const int*)p;
  a.ld = ld;
  a.cnt = (const int*)cnt;
  a.n = n;
  a.cap = cap;
  a.kp = kp;
  a.scratch = (sel_key_t*)scratch;
  a.out_s = (float*)out_s;
  a.out_i = (int*)out_i;
  a.bound = (float*)bound;
  a.overflow = (int*)overflow;
  return launch_topk_select(a, B, (cudaStream_t)stream);
}
