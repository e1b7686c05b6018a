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
__device__ __forceinline__ float dot_chunk(const uint4& v, const float* qs);

// 16 int8 codes against 16 query values (qs is 16-byte aligned shared memory)
template <>
__device__ __forceinline__ float dot_chunk<int8_t>(const uint4& v, const float* qs) {
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 qv = q4[i];
    acc = fmaf((float)(int8_t)(w[i] & 0xff), qv.x, acc);
    acc = fmaf((float)(int8_t)((w[i] >> 8) & 0xff), qv.y, acc);
    acc = fmaf((float)(int8_t)((w[i] >> 16) & 0xff), qv.z, acc);
    acc = fmaf((float)(int8_t)(w[i] >> 24), qv.w, acc);
  }
  return acc;
}

// 4 fp32 values against 4 query values
template <>
__device__ __forceinline__ float dot_chunk<float>(const uint4& v, const float* qs) {
  const float4 qv = *reinterpret_cast<const float4*>(qs);
  float acc = __uint_as_float(v.x) * qv.x;
  acc = fmaf(__uint_as_float(v.y), qv.y, acc);
  acc = fmaf(__uint_as_float(v.z), qv.z, acc);
  acc = fmaf(__uint_as_float(v.w), qv.w, acc);
  return acc;
}

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
  constexpr int kPer = 16 / sizeof(T);       // elements per 16-byte load
  for (int r = r0 + warp; r < r1; r += kThreads / 32) {
    const size_t slot = (size_t)(in_range ? cl : 0) * cap + r;
    const int id = in_range ? ids[slot] : -1;
    if (id < 0) {                            // warp-uniform branch
      if (lane == 0) o[r] = -INFINITY;
      continue;
    }
    const T* row = vecs + slot * D;
    float acc = 0.f;
    if (vectorized) {
      const uint4* row4 = reinterpret_cast<const uint4*>(row);
      const int nchunk = D / kPer;
#pragma unroll 4
      for (int c = lane; c < nchunk; c += 32)
        acc += dot_chunk<T>(__ldg(row4 + c), qs + c * kPer);
    } else {
      for (int k = lane; k < D; k += 32) acc = fmaf((float)row[k], qs[k], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) o[r] = scales != nullptr ? acc * scales[slot] : acc;
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
