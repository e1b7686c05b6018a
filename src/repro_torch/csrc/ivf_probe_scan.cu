// IVF probe scan, SQ8 and fp32 lists.
//
// Replaces: src/repro/kernels/gather_scan.py:ivf_probe_scan
//   (_ivf_scan_sq8_kernel, _ivf_scan_fp_kernel), a scalar-prefetch Pallas
//   kernel with grid (B, nprobe) that DMAs cluster probe[b, p]'s (cap, d')
//   list into VMEM and scores it on the MXU.
//
// Bound on the H100: device-memory bytes.  Each probed list row is d' int8
// codes (2 KB at d' = 2048) plus a 4-byte scale, and it is used for one
// fp32 dot of d' multiply-adds: about one operation per byte, far below the
// card's ~20 fp32 operations per byte of bandwidth.
//
// Design: one block per (query b, probe p, tile of kRowsPerBlock slots).
// The block reads probe[b, p] itself (the scalar prefetch of the TPU
// version), stages q[b] in shared memory once, and each warp streams whole
// rows of the cluster's list straight from device memory, 16 bytes per lane
// per load; no gathered copy of the lists is ever made.  Pad slots (id < 0)
// are not read at all and score -inf.  SQ8 numerics: the fp32 dot of q with
// (float)code, then times the row scale, which is what the CPU oracle
// computes (the TPU's hi/lo-bf16 split worked around its MXU and is not
// needed here).  The sum order differs from the oracle, so results agree to
// fp32 rounding, not bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(const float* __restrict__ q, const int* __restrict__ probe,
                const int* __restrict__ ids, const T* __restrict__ vecs,
                const float* __restrict__ scales, float* __restrict__ out,
                int P, int cap, int D, int nlist, int vectorized) {
  extern __shared__ __align__(16) float qs[];
  const int bp = blockIdx.x;                 // b * P + p
  const int b = bp / P;
  const int cl = probe[bp];
  for (int i = threadIdx.x; i < D; i += kThreads) qs[i] = q[(size_t)b * D + i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * kRowsPerBlock;
  const int r1 = min(r0 + kRowsPerBlock, cap);
  const bool in_range = cl >= 0 && cl < nlist;
  float* o = out + (size_t)bp * cap;
  for (int r = r0 + warp; r < r1; r += kThreads / 32) {
    const size_t slot = (size_t)(in_range ? cl : 0) * cap + r;
    const int id = in_range ? ids[slot] : -1;
    if (id < 0) {                            // warp-uniform branch
      if (lane == 0) o[r] = -INFINITY;
      continue;
    }
    const T* row[1] = {vecs + slot * D};
    float acc[1];
    warp_rows_dot<1, T>(row, qs, D, vectorized, lane, acc);
    if (lane == 0) o[r] = scales != nullptr ? acc[0] * scales[slot] : acc[0];
  }
}

template <typename T>
int launch(const float* q, const int* probe, const int* ids, const T* vecs,
           const float* scales, float* out, int B, int P, int cap, int D,
           int nlist, cudaStream_t stream) {
  const int vectorized = (D % (16 / (int)sizeof(T)) == 0) &&
                         (reinterpret_cast<uintptr_t>(vecs) % 16 == 0);
  const size_t smem = (size_t)((D + 3) / 4 * 4) * sizeof(float);
  cudaError_t err = allow_smem(ivf_scan_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * P), (unsigned)((cap + kRowsPerBlock - 1) / kRowsPerBlock));
  ivf_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      q, probe, ids, vecs, scales, out, P, cap, D, nlist, vectorized);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ivf_probe_scan_sq8(const void* q, const void* probe, const void* ids,
                                  const void* codes, const void* scales, void* out,
                                  int B, int P, int cap, int D, int nlist,
                                  void* stream) {
  return launch<int8_t>((const float*)q, (const int*)probe, (const int*)ids,
                        (const int8_t*)codes, (const float*)scales, (float*)out,
                        B, P, cap, D, nlist, (cudaStream_t)stream);
}

extern "C" int ivf_probe_scan_fp32(const void* q, const void* probe, const void* ids,
                                   const void* vecs, void* out, int B, int P,
                                   int cap, int D, int nlist, void* stream) {
  return launch<float>((const float*)q, (const int*)probe, (const int*)ids,
                       (const float*)vecs, nullptr, (float*)out, B, P, cap, D,
                       nlist, (cudaStream_t)stream);
}
