// IVF probe scan over residual lists (packed 2/4-bit codes against each
// list's own centroid), decoded at the source.
//
// Replaces: src/repro/kernels/gather_scan.py:ivf_probe_res_scan
//   (_ivf_scan_res_kernel, _unpack_codes_i32, _residual_values), a
//   scalar-prefetch Pallas kernel with grid (B, nprobe) that DMAs cluster
//   probe[b, p]'s packed (cap, d' bits / 8) codes and its centroid row into
//   VMEM, decodes them there (a select-sum over the levels) and scores the
//   list on the MXU.
//
// Bound on the H100: the lookups' instructions.  A probed row is d' / 2
// bytes at 4 bits (1 KB at d' = 2048), a quarter of the SQ8 row, and costs d'
// lookups and adds, so the bytes' bound (0.26 ms at the served shape) is
// out of reach of a design built on lookups: each code costs a shift, a
// lookup and an add, about 4 instructions, so 256 queries x 12,471 rows x
// 2,048 codes take at least about 0.9 ms at 4 instructions a clock an SM on
// 132 SMs (the lookup floor).
//
// Design: one block per (query b, probe p), which reads probe[b, p] itself
// and runs residual.cuh's res_scan over the list: its 8 warps split the
// list's slots, a ballot keeps the live ones (pads are never read; they
// score -inf) and the block scores them 1,024 at a time against a table of
// q[k] values[k][l] built a tile of 512 dims at a time, then adds q . c of
// the list's centroid (one warp dot).  query_fused_res scores rows with the
// same code, so a row gets the same bits on both residual routes.  The sum
// runs in another order than the plain version's decode-then-score, so
// scores agree to fp32 rounding.  Any d' that quantization.pack_codes takes
// (even at 4 bits, a multiple of 4 at 2): a packed row that is not whole
// 4-byte words is read a byte at a time (residual.cuh), with the same sums.
#include "residual.cuh"

namespace {

template <int BITS, bool WHOLE>
__global__ void __launch_bounds__(kResThreads, 2)
ivf_scan_res_kernel(const float* __restrict__ q, const int* __restrict__ probe,
                    const int* __restrict__ ids, const uint8_t* __restrict__ codes,
                    const float* __restrict__ centroids, const float* __restrict__ values,
                    float* __restrict__ out, int P, int cap, int D, int nlist) {
  extern __shared__ __align__(16) float sm[];
  const int bp = blockIdx.x;                 // b * P + p
  res_scan<BITS, WHOLE>(probe + bp, kResWarps, kResWarps, 1, 0, q + (size_t)(bp / P) * D, ids,
                        codes, centroids, values, out + (size_t)bp * cap, cap, D, nlist, sm);
}

template <int BITS, bool WHOLE>
int launch(const float* q, const int* probe, const int* ids, const uint8_t* codes,
           const float* centroids, const float* values, float* out, int B, int P,
           int cap, int D, int nlist, cudaStream_t stream) {
  const size_t smem = res_smem_floats(BITS) * sizeof(float);
  cudaError_t err = allow_smem(ivf_scan_res_kernel<BITS, WHOLE>, smem);
  if (err != cudaSuccess) return (int)err;
  ivf_scan_res_kernel<BITS, WHOLE><<<(unsigned)(B * P), kResThreads, smem, stream>>>(
      q, probe, ids, codes, centroids, values, out, P, cap, D, nlist);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, D) fp32; probe (B, P) int32; ids (nlist, cap) int32; codes (nlist,
// cap, D * bits / 8) uint8; centroids (nlist, D) fp32; values (D, 2^bits)
// fp32 -> out (B, P, cap) fp32.  bits is 2 or 4.
extern "C" int ivf_probe_res_scan(const void* q, const void* probe, const void* ids,
                                  const void* codes, const void* centroids,
                                  const void* values, void* out, int B, int P, int cap,
                                  int D, int nlist, int bits, void* stream) {
#define LEMUR_RES_SCAN(BITS)                                                         \
  return (res_whole_words(codes, D, BITS) ? launch<BITS, true> : launch<BITS, false>)( \
      (const float*)q, (const int*)probe, (const int*)ids, (const uint8_t*)codes,     \
      (const float*)centroids, (const float*)values, (float*)out, B, P, cap, D, nlist, \
      (cudaStream_t)stream)
  if (bits == 4) LEMUR_RES_SCAN(4);
  if (bits == 2) LEMUR_RES_SCAN(2);
#undef LEMUR_RES_SCAN
  return (int)cudaErrorInvalidValue;
}
