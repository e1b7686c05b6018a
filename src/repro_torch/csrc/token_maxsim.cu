// Token-level MaxSim: out[i, l] = max over valid tokens t of doc l of
// <x[i], docs[l, t]>, and NEG where doc l has no valid token.
//
// Replaces: src/repro/kernels/maxsim.py:token_maxsim (_token_maxsim_kernel),
//   a Pallas kernel with grid (n / 256, m / 64) that views a (64, T, d) docs
//   tile as one (64 T, d) matrix, runs one MXU matmul against a (256, d)
//   x tile and takes a masked max over T.
//
// Bound on the H100: tensor-core operations.  Each (OLS token, doc token)
// pair costs d multiply-adds; at the build's shapes (d = 128, a mean of
// 67.4 valid tokens of T = 80) one OLS block of n' = 16,384 tokens against
// 2,048 docs is 579 GFLOP over 226 MB.  The 3xTF32 split makes that 3
// TF32 products: 3.51 ms at 495 TFLOP/s (4.17 ms with the masked positions,
// which the tensor cores compute too), against 8.6 ms for fp32 on the CUDA
// cores.
//
// Design: the MaxSim body of maxsim_tc.cuh.  The OLS tokens are the
// reused operand: tc_image writes their split pieces once, in tiles of 128
// tokens, and a block keeps its tile's image in shared memory (d <= 128;
// wider tiles stream through the ring).  The docs are the streamed operand,
// (m T, d) rows contiguous per doc: each consumer warp takes one doc of a
// round of 8, 16 token rows a wgmma, split in registers; masked rows are
// not read.  The max over a doc's rows ends in registers (a reduce-scatter
// over the warp's row lanes, a running max across its 16-row slices), and
// a round's 8 docs leave through shared memory as 8 consecutive floats of
// each out row.  Tiles vary fastest over the grid, so the blocks in flight
// share a run of docs and read it from L2.  Two launches: the image, then
// the product.
#include "maxsim_tc.cuh"

namespace {

constexpr int kRowsTile = 128;   // OLS tokens a block: wgmma's N

}  // namespace

// x (n, D) fp32; docs (m, T, D) fp32; mask (m, T) bytes; out (n, m) fp32;
// img: scratch for x's image (ceil(n / 128) x ceil(D / 32) x 8,192 floats).
extern "C" int token_maxsim(const void* x, const void* docs, const void* mask, void* out,
                            void* img, int n, int m, int T, int D, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = launch_tc_image<kRowsTile>((const float*)x, (float*)img, 1, n, D, s);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  MxArgs a{};
  a.img = (const float*)img;
  a.tok = docs;
  a.mask = (const uint8_t*)mask;
  a.out = (float*)out;
  a.D = D;
  a.Tr = T;
  a.NT = 1;
  a.n = n;
  a.items = m;
  a.groups = (n + kRowsTile - 1) / kRowsTile;
  a.rounds = (m + kMxWarps - 1) / kMxWarps;
  // about two blocks an SM in all, each with as long a run of docs as that allows
  a.runs = (2 * sms + a.groups - 1) / a.groups;
  return launch_maxsim_tc<float, kRowsTile, kMxTokenMaxSim>(a, s);
}
