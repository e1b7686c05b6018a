// SQ8 latent scans: fp32 queries against int8 rows with per-row scales.
//
// Replaces: src/repro/kernels/mips_sq8.py:mips_sq8 (_mips_sq8_kernel), a
//   tiled (block_q, d) x (block_m, d) Pallas product that widens the codes
//   to bf16 and splits the query into hi and lo bf16 halves for the MXU.
//   The JAX package's legacy IVF scan (ops.mips_sq8_batched) flattens each
//   query's gathered rows into one all-pairs call and keeps each query's own
//   strip: B times the work, which is why it sends every shape past 256 MB
//   to the plain einsum.
//
// Numerics: the fp32 dot with the widened codes, then the row scale, as the
// CPU oracle and the port's probe scan compute it; the all-pairs entry
// reaches it on the tensor cores through an error-compensated split of q
// (tc_scan.cuh).  Sums run in another order than the plain versions, so
// results agree to fp32 rounding.
//
// Two entry points:
//  - batched strips, the legacy IVF scan: q (B, d) against each query's own
//    (n, d) rows -> (B, n).  Bound on the H100: device-memory bytes (each
//    code row is read once for d multiply-adds, one operation per byte).
//    One block per (query, tile of kRowsPerBlock rows), q in shared memory,
//    a warp a row through the probe scan's row dot (common.cuh), 16 bytes a
//    lane a load; no B-fold waste.
//  - all pairs: q (B, d) against (m, d) rows -> (B, m).  Bound: tensor-core
//    operations once B is past about 40 (2 TF32 products of 2 B m d at
//    495 TFLOP/s against the codes' bytes at 3.35 TB/s).  The dense scan's product on
//    the tensor cores (tc_scan.cuh: wgmma, q split in two TF32 pieces, the
//    int8 codes exact in TF32, the row scale after the sum) in its store
//    mode; two launches (q's split image, then the product).
#include "tc_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 128;

__global__ void __launch_bounds__(kThreads)
mips_sq8_batched_kernel(const float* __restrict__ q, const int8_t* __restrict__ codes,
                        const float* __restrict__ scales, float* __restrict__ out,
                        int B, int n, int D, int vectorized) {
  extern __shared__ __align__(16) float qs[];
  // one grid axis of (row tile, query) blocks, the query fastest (any n)
  const int tile = blockIdx.x / B, b = blockIdx.x - tile * B;
  for (int i = threadIdx.x; i < D; i += kThreads) qs[i] = q[(size_t)b * D + i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r1 = min((tile + 1) * kRowsPerBlock, n);
  for (int r = tile * kRowsPerBlock + warp; r < r1; r += kThreads / 32) {
    const size_t row = (size_t)b * n + r;
    const int8_t* rows[1] = {codes + row * D};
    float acc[1];
    warp_rows_dot<1, int8_t>(rows, qs, D, vectorized, lane, acc);
    if (lane == 0) out[row] = acc[0] * scales[row];
  }
}

}  // namespace

extern "C" int mips_sq8_batched(const void* q, const void* codes, const void* scales,
                                void* out, int B, int n, int D, void* stream) {
  const int vectorized = (D % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  const size_t smem = (size_t)((D + 3) / 4 * 4) * sizeof(float);
  cudaError_t err = allow_smem(mips_sq8_batched_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (long long)B * ((n + kRowsPerBlock - 1) / kRowsPerBlock);
  if (grid == 0) return (int)cudaSuccess;
  if (grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  mips_sq8_batched_kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const int8_t*)codes, (const float*)scales, (float*)out, B, n, D,
      vectorized);
  return (int)cudaGetLastError();
}

// img: scratch for q's split image (tc_scan.cuh: ceil(B / 128) x ceil(D /
// 32) x 8,192 floats).
extern "C" int mips_sq8_pairs(const void* q, const void* codes, const void* scales,
                              void* out, void* img, int B, int m, int D, void* stream) {
  int err = launch_tc_q_image((const float*)q, (float*)img, B, D, (cudaStream_t)stream);
  if (err != 0) return err;
  TcScan a{};
  a.img = (const float*)img;
  a.W = codes;
  a.scales = (const float*)scales;
  a.B = B;
  a.m = m;
  a.D = D;
  a.rs = 1;
  a.out = (float*)out;
  a.ldo = m;
  return launch_tc_scan<int8_t, false>(a, (cudaStream_t)stream);
}
