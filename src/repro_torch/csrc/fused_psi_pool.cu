// Fused feature encoder psi(x) = LN(GELU_tanh(x W' + b)), with the masked
// query pool sum_t mask_t * psi(x_t) fused in.
//
// Replaces: src/repro/kernels/fused_psi.py:fused_psi (_fused_psi_kernel), a
//   Pallas kernel that keeps a (block_n, d') row tile in VMEM so that the
//   LayerNorm reduction over the full d' stays local.  The JAX serving path
//   computes the pool in jnp (core/model.py:pool_queries); here it runs
//   through this kernel.
//
// Bound on the H100: operations.  A batch of 256 queries x 32 tokens is
// 2 x 8192 x 128 x 2048 = 4.3 GFLOP against about 7 MB of inputs and
// outputs, so the fp32 CUDA-core rate bounds it (no tensor cores: the
// product stays in fp32 FMA, as the reference computes it).
//
// Design: one block per segment of seg_len rows (one query's Tq tokens when
// pooling).  Rows go through in tiles of kRows: the x tile sits in shared
// memory and is read as broadcasts, each thread owns C columns of d'
// (column j = tid + 256 c, coalesced reads of W') and keeps a kRows x C
// register tile of the product.  GELU output for the whole tile is held in
// shared memory (kRows x d' fp32, 64 KB at d' = 2048) so one warp per row
// can take the LayerNorm mean and variance over the full d' (two passes,
// as the reference does).  Then each thread normalises its columns, applies
// gamma and beta, and either writes the row (unpooled form) or adds
// mask_t * y into a per-thread pooled accumulator that is written once per
// segment.  The mask is applied after psi, so a masked token adds 0 even
// though psi(0) != 0.
#include "psi.cuh"

// pool != 0: out is (n_rows / seg_len, Dp), the masked sum of each segment
// (mask may be null: every row counts).  pool == 0: out is (n_rows, Dp).
extern "C" int fused_psi(const void* x, const void* mask, const void* W,
                         const void* bias, const void* gamma, const void* beta,
                         void* out, int n_rows, int seg_len, int D, int Dp,
                         int pool, float eps, void* stream) {
  return launch_fused_psi((const float*)x, (const uint8_t*)mask, (const float*)W,
                          (const float*)bias, (const float*)gamma, (const float*)beta,
                          (float*)out, n_rows, seg_len, D, Dp, pool, eps,
                          (cudaStream_t)stream);
}
