// Shared helpers of the kernels (each .cu is its own shared library with a
// plain C interface; see src/repro_torch/kernels/build.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LEMUR_NEG (-1e30f)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One 16-byte chunk of a row against the matching query values (qs is
// 16-byte aligned shared memory): 16 int8 codes or 4 fp32 values.
template <typename T>
__device__ __forceinline__ float dot_chunk(const uint4& v, const float* qs);

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

template <>
__device__ __forceinline__ float dot_chunk<float>(const uint4& v, const float* qs) {
  const float4 qv = *reinterpret_cast<const float4*>(qs);
  float acc = __uint_as_float(v.x) * qv.x;
  acc = fmaf(__uint_as_float(v.y), qv.y, acc);
  acc = fmaf(__uint_as_float(v.z), qv.z, acc);
  acc = fmaf(__uint_as_float(v.w), qv.w, acc);
  return acc;
}

// The fp32 dot of each of R rows of D values (int8 codes widened, or fp32)
// with the query in shared memory, by a whole warp: lane l takes the 16-byte
// chunks l, l + 32, ... of every row straight from device memory, the R
// rows' loads in flight together.  Each row sums in the same order whatever
// R, and the butterfly sum leaves the same bits in every lane, so every
// kernel that scores rows this way gets the same bits for the same row.  A
// null row is not read and scores 0.  `vectorized`: D is a multiple of
// 16 / sizeof(T) and the rows start on 16 bytes.
template <int R, typename T>
__device__ __forceinline__ void warp_rows_dot(const T* const (&rows)[R], const float* qs,
                                              int D, bool vectorized, int lane,
                                              float (&s)[R]) {
  float acc[R];
#pragma unroll
  for (int h = 0; h < R; ++h) acc[h] = 0.f;
  if (vectorized) {
    constexpr int kPer = 16 / sizeof(T);
    const int nchunk = D / kPer;
#pragma unroll 4
    for (int c = lane; c < nchunk; c += 32) {
      uint4 v[R];
#pragma unroll
      for (int h = 0; h < R; ++h)
        v[h] = rows[h] != nullptr ? __ldg(reinterpret_cast<const uint4*>(rows[h]) + c)
                                  : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int h = 0; h < R; ++h) acc[h] += dot_chunk<T>(v[h], qs + c * kPer);
    }
  } else {
    for (int k = lane; k < D; k += 32)
#pragma unroll
      for (int h = 0; h < R; ++h)
        if (rows[h] != nullptr) acc[h] = fmaf((float)rows[h][k], qs[k], acc[h]);
  }
#pragma unroll
  for (int h = 0; h < R; ++h) s[h] = warp_sum(acc[h]);
}

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs
// it (a launch above the default limit is refused otherwise).  The default
// limit counts the kernel's static shared memory too, so the opt-in starts
// a kilobyte early.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 47 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The most dynamic shared memory a block may opt into on the card (asked
// once: every launch of the reranks wants it).
inline cudaError_t smem_optin(int* bytes) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, v = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cached = v;
  }
  *bytes = cached;
  return cudaSuccess;
}

extern "C" const char* lemur_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
