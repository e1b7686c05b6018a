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
// Bound on the H100: the decode's instructions.  A probed row is d' / 2
// bytes at 4 bits (1 KB at d' = 2048), a quarter of the SQ8 row, and costs d'
// lookups and adds, so the bytes' bound is about a quarter of the SQ8
// scan's while each byte carries four times the work: the kernel is bounded
// by its issue rate (a shared-memory lookup a code), not by device memory.
//
// Design: one block per (query b, probe p), which reads probe[b, p] itself
// and scores the list kResChunk = 1024 slots at a time with residual.cuh's
// res_score_chunk: d' is walked in tiles of 512 dims, and for each tile the
// block writes every product a code can give, q[k] * (centroid[k] +
// values[k][l]), to shared memory (34 KB at 4 bits; the whole (2048, 16)
// table would take 128 KB and one block an SM), read coalesced from L2 once
// a tile a block; a warp's rows arrive as 4-byte words, all in flight
// together, and each code then costs a shift, one lookup and one add, lanes
// on their own banks (the table's columns are padded).  Pad slots (id < 0)
// are not read and score -inf.  The decoded element is the host decoder's
// bits; the sum runs in another order than the plain version's, so scores
// agree to fp32 rounding.  Any d' that quantization.pack_codes takes (even
// at 4 bits, a multiple of 4 at 2): a packed row that is not whole 4-byte
// words is read a byte at a time (residual.cuh), with the same sums.
#include "residual.cuh"

namespace {

template <int BITS, bool WHOLE>
__global__ void __launch_bounds__(kResThreads)
ivf_scan_res_kernel(const float* __restrict__ q, const int* __restrict__ probe,
                    const int* __restrict__ ids, const uint8_t* __restrict__ codes,
                    const float* __restrict__ centroids, const float* __restrict__ values,
                    float* __restrict__ out, int P, int cap, int D, int nlist) {
  extern __shared__ __align__(16) float sm[];
  const int bp = blockIdx.x;                 // b * P + p
  const int b = bp / P;
  const int cl = probe[bp];
  float* o = out + (size_t)bp * cap;
  if (cl < 0 || cl >= nlist) {               // block-uniform: every slot a pad
    for (int r = threadIdx.x; r < cap; r += kResThreads) o[r] = -INFINITY;
    return;
  }
  const int* lid = ids + (size_t)cl * cap;
  const size_t db = D / ResCodes<BITS>::kPer;
  const float* acc = sm + ResCodes<BITS>::kLevels * kResTileStride;
  for (int c0 = 0; c0 < cap; c0 += kResChunk) {
    const int c1 = min(c0 + kResChunk, cap);
    res_score_chunk<BITS, WHOLE>(codes + (size_t)cl * cap * db, lid, c0, c1,
                          centroids + (size_t)cl * D, values, q + (size_t)b * D, D, sm);
    for (int r = c0 + threadIdx.x; r < c1; r += kResThreads)
      o[r] = lid[r] >= 0 ? acc[r - c0] : -INFINITY;
  }
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
