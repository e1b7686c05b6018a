// Shared helpers of the serving kernels (each .cu is its own shared library
// with a plain C interface; see src/repro_torch/kernels/build.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LEMUR_NEG (-1e30f)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs
// it (a launch above the default limit is refused otherwise).
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

extern "C" const char* lemur_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
