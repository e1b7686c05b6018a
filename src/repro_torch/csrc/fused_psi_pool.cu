// Fused feature encoder psi(x) = LN(GELU_tanh(x W' + b)), with the masked
// query pool sum_t mask_t * psi(x_t) fused in.
//
// Replaces: src/repro/kernels/fused_psi.py:fused_psi (_fused_psi_kernel), a
//   Pallas kernel that keeps a (block_n, d') row tile in VMEM so that the
//   LayerNorm reduction over the full d' stays local, and the pool of the
//   one-launch kernels (src/repro/kernels/query_fused.py:_pool_psi).  The JAX
//   serving path computes the pool in jnp (core/model.py:pool_queries); here
//   it runs through this kernel, once a search on every route: the
//   one-launch kernels take its latent.
//
// Bound on the H100: tensor-core operations.  A batch of 256 queries x 32
// tokens is 2 x 8,192 x 128 x 2,048 = 4.3 GFLOP, three TF32 products of it
// under the split (0.026 ms at 495 TFLOP/s; 0.064 ms in fp32 on the CUDA
// cores), against about 7.4 MB of inputs and outputs (0.002 ms).
//
// Design (psi.cuh): the product on the tensor cores with the 3xTF32 split
// (tc_common.cuh), so each psi entry is an fp32 product up to rounding, as
// in the port's other tensor-core kernels: a small kernel first writes
// W'^T's split pieces in wgmma's B image, then a cluster of ceil(d' / 256)
// blocks takes each 64-row tile of x, block r the 256 columns
// [256 r, 256 r + 256) of d' (128 a consumer warpgroup), W' streamed
// through a two-stage ring of 64 KB across the tiles of a persistent
// cluster (one pass of a block's 256 KB slice for 64 rows, where one block
// a query read all of W' for every 8).  The sums stay in registers: bias
// and GELU there (GELU as x / (1 + exp(-2u)), no branch), then the
// LayerNorm statistics: each block's row sums, then its squared deviations
// about its own row mean (two passes, as the reference), sent to the other
// blocks of the cluster by st.async in one round trip a tile and combined
// in rank order by Chan's pairwise update, var = sum_b (M2_b + n_b (mean_b
// - mean)^2) / d'; no (rows x d') tile in shared memory.  The pool adds
// mask_t * y over each query's rows in a fixed order and writes each sum
// once, without atomics, so two calls give the same bits.  The mask is
// applied after psi: a masked token adds 0 although psi(0) != 0.  Any n,
// Tq (a query may span tiles), d (its chunks of 32 loop) and d' <= 4,096
// (clusters of up to 16 blocks).
//
// What bounds it now (kernels/psi_ablation.py; PERF.md §6): the epilogue
// runs after each tile's product on the same 8 warps of an SM, so neither
// overlaps the other; the tensor cores run at about a third of their rate
// through the register-split A operand, as in tc_scan.cuh.
#include "psi.cuh"

// pool != 0: out is (n_rows / seg_len, Dp), the masked sum of each segment
// (mask may be null: every row counts).  pool == 0: out is (n_rows, Dp).
// img: psi_image_floats(D, Dp) floats of device memory for W''s image.
extern "C" int fused_psi(const void* x, const void* mask, const void* W,
                         const void* bias, const void* gamma, const void* beta,
                         void* out, void* img, int n_rows, int seg_len, int D, int Dp,
                         int pool, float eps, void* stream) {
  return launch_fused_psi((const float*)x, (const uint8_t*)mask, (const float*)W,
                          (const float*)bias, (const float*)gamma, (const float*)beta,
                          (float*)out, (float*)img, n_rows, seg_len, D, Dp, pool, eps,
                          (cudaStream_t)stream);
}

extern "C" long long fused_psi_image_floats(int D, int Dp) { return psi_image_floats(D, Dp); }
