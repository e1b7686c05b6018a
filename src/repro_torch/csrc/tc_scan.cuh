// The dense latent product q . W^T on Hopper's tensor cores, for the dense
// scan's passes (query_fused.cu: mips_topk) and the all-pairs SQ8 scan
// (mips_sq8.cu).
//
// Numerics (tc_common.cuh): an error-compensated split, so that the
// scores are those of an fp32 product up to fp32 rounding: 3xTF32 for fp32
// rows, 2xTF32 for SQ8 rows (the codes are exact in TF32; only q is split,
// and the row scale multiplies the sum afterwards); the tensor cores' sum
// restarts every kTcFlush chunks (64 columns) into a rounded fp32 total (24
// or 16 wgmmas at a time over d' = 2048, against 768 in one accumulator).
// tests/test_torch_query_fused.py::test_tf32_split_error emulates this
// arithmetic on the CPU at d' = 2048 against an fp64 product.
//
// Bound on the H100: tensor-core operations, 3 (fp32) or 2 (SQ8) TF32
// products of 2 B m d' at 495 TFLOP/s, against W's bytes once at 3.35 TB/s
// (5.1 ms and 2.0 ms at B = 256 over 800k fp32 rows of d' = 2048).
//
// Design: wgmma (sm_90a) in its RS form, A from registers, B from shared
// memory, both K-major as stored.  A block tile is kTcRows = 128 rows of W
// (two consumer warpgroups, 64 rows each, wgmma's M) by kTcQ = 128 queries
// (wgmma's N; the chunk's accumulator and the running total take 64
// registers each), walked along d' in chunks of kTcK = 32:
//  - B: a small kernel (tc_q_image) first writes q's split pieces in the
//    exact shared-memory image of each (query tile, chunk): wgmma's
//    canonical K-major layout without swizzle (8 x 16-byte core matrices,
//    SBO 128 bytes between 8-query groups, LBO 2048 bytes between 4-column
//    groups), 32 KB a chunk.  A producer thread streams the chunks with one
//    bulk copy each (cp.async.bulk, completion on an mbarrier) through a
//    ring of kTcStages stages; the consumers free a stage through a second
//    mbarrier once its wgmmas have finished: a wait for all but the
//    newest k-step group, two k-steps into the next chunk, shows it (the
//    consumers drain their wgmmas only every kTcFlush chunks).  Its
//    warpgroup hands its registers to the consumers (setmaxnreg: 40 a
//    thread, 232 for them).
//  - A: each consumer thread copies its fragment's W values (rows g and g
//    + 8 of its warp's 16, 8 contiguous values of each: 32 bytes of an fp32
//    row, 8 of an int8 one) with cp.async into its own slot of a
//    shared-memory ring, kTcWStages chunks ahead (a chunk of int8 rows is
//    too short to hide device memory's latency one chunk ahead), reads
//    them back when their chunk comes and splits them in registers.  So
//    that a thread's 8 values are contiguous, the chunk's columns are
//    permuted: at k-step s of the chunk, fragment column c < 4 is column
//    8c + 2s and column c + 4 is 8c + 2s + 1; the image puts q's columns
//    in the same places.
//  - Blocks are persistent (one an SM), each walking tiles blockIdx.x,
//    blockIdx.x + gridDim.x, ..., the query tile fastest; the producer runs
//    ahead across tile boundaries, so one tile's epilogue overlaps the
//    next tile's copies and loads.  The two query tiles of a batch of 256
//    are neighbours in that order, so W's rows come from device memory
//    once and from L2 the second time.
//  - Epilogue (the totals of a thread: rows g, g + 8, queries 8j + 2t,
//    8j + 2t + 1): the SQ8 row scale, invalid rows pinned to NEG, then
//    either the score is stored (B, m) query-major, or it is compared with
//    its query's bound and appended, if not below it, to the query's
//    candidates (one atomic a thread, column and tile).
// A row's score does not depend on where the row sits in a tile or which
// rows are around it: every output element sums the same chunks, k-steps
// and pieces in the same order.  So the dense scan's pass over every 32nd
// row (a row stride) scores those rows to the bit as the filtered pass
// over all rows does, and its k'-th score is a bound the filter can trust.
#pragma once

#include "tc_common.cuh"

constexpr int kTcRows = 128;                  // W rows of a tile
constexpr int kTcQ = 128;                     // queries of a tile
constexpr int kTcStages = 4;
constexpr int kTcPiece = kTcQ * kTcK;         // floats of one split piece of a chunk
constexpr int kTcChunk = 2 * kTcPiece;        // (qh, ql): 32 KB
constexpr int kTcLbo = kTcQ / 8 * 128;        // bytes between a k-step's column halves
constexpr size_t kTcSmem = ((size_t)kTcStages * kTcChunk +
                            (size_t)kTcWStages * kTcConsumers * kTcWSlot) * sizeof(float) +
                           2 * kTcStages * 8;

__host__ __device__ inline int tc_query_tiles(int B) { return (B + kTcQ - 1) / kTcQ; }

// q's split pieces in the B image of every (query tile, chunk)
// (tc_common.cuh: tc_image, N = kTcQ).
static int launch_tc_q_image(const float* q, float* img, int B, int D, cudaStream_t stream) {
  return launch_tc_image<kTcQ>(q, img, 1, B, D, stream);
}

// -- the product kernel ---------------------------------------------------------

struct TcScan {
  const float* img;       // tc_q_image of q (B queries, D columns)
  const void* W;          // (rows, D) fp32 or int8; logical row r is physical row r * rs
  const float* scales;    // (rows,) or null
  const uint8_t* valid;   // (rows,) or null: invalid rows score NEG
  int B, m, D, rs, vec;   // m logical rows; vec: 16-byte (fp32) / 8-byte (int8) loads
  // store: out[b * ldo + r]
  float* out;
  long long ldo;
  // filter: thr (B,) bounds; cnt (B,) zeroed; buf_s / buf_p (B, cap)
  const float* thr;
  int* cnt;
  float* buf_s;
  int* buf_p;
  int cap;
};

// Start copying a consumer thread's W values of one chunk into its slot:
// rows row0 and row0 + 8, columns 8t .. 8t + 7 of the chunk (fp32: 16
// floats; int8: 16 bytes), 0 past m or D.
template <typename T>
__device__ __forceinline__ void tc_fetch(const TcScan& a, int row0, int kc, int t, float* slot) {
  const T* W = static_cast<const T*>(a.W);
  const int k0 = kc * kTcK + 8 * t;
  const T* p[2];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    ok[h] = row < a.m;
    p[h] = ok[h] ? W + (size_t)row * a.rs * a.D + k0 : W;
  }
  tc_fetch_rows<T>(p, ok, k0, a.D, a.vec, slot);
}

template <typename T, bool FILTER>
__global__ void __launch_bounds__(kTcThreads, 1) tc_scan_kernel(const TcScan a) {
  extern __shared__ __align__(128) float tc_sm[];
  float* stages = tc_sm;
  float* wring = tc_sm + kTcStages * kTcChunk;   // kTcWStages x kTcConsumers slots
  uint64_t* full = reinterpret_cast<uint64_t*>(wring + kTcWStages * kTcConsumers * kTcWSlot);
  uint64_t* empty = full + kTcStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int KC = tc_chunks(a.D), NT = tc_query_tiles(a.B);
  const int ntiles = (a.m + kTcRows - 1) / kTcRows * NT;
  const int my_tiles = ntiles > (int)blockIdx.x ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int steps = my_tiles * KC;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcConsumers / 32);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kTcConsumers / 32) {                // the producer warpgroup: one thread
    // copies; its registers go to the consumers (128 x 40 + 256 x 232 <= 65,536)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kTcConsumers) {
      for (int it = 0; it < steps; ++it) {
        const int s = it % kTcStages;
        if (it >= kTcStages) mbar_wait(&empty[s], ((it / kTcStages) - 1) & 1);
        const int tile = blockIdx.x + (it / KC) * gridDim.x;
        const int nt = tile % NT, kc = it % KC;
        mbar_expect_tx(&full[s], kTcChunk * sizeof(float));
        bulk_copy_g2s(stages + (size_t)s * kTcChunk, a.img + ((size_t)nt * KC + kc) * kTcChunk,
                      kTcChunk * sizeof(float), &full[s]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, t = lane & 3;
  float acc[64], tot[64];                        // the chunk's sum, the running total
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
  float cur[2][8];
  uint32_t A[2][2][4];                           // [k-step & 1][hi, lo][register]
  auto row_of = [&](int it) {
    const int tile = blockIdx.x + (it / KC) * gridDim.x;
    return tile / NT * kTcRows + wg * 64 + wi * 16 + g;
  };
  auto slot_of = [&](int it) {
    return wring + ((size_t)(it % kTcWStages) * kTcConsumers + threadIdx.x) * kTcWSlot;
  };
#pragma unroll
  for (int i = 0; i < kTcWStages - 1; ++i) {
    if (i < steps) tc_fetch<T>(a, row_of(i), i % KC, t, slot_of(i));
    else cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    const int kc = it % KC, s = it % kTcStages;
    const int ahead = it + kTcWStages - 1;         // its slot was read last step
    if (ahead < steps) tc_fetch<T>(a, row_of(ahead), ahead % KC, t, slot_of(ahead));
    else cp_async_commit();
    cp_async_wait<kTcWStages - 1>();               // chunk it has landed
    tc_read<T>(slot_of(it), cur);
    mbar_wait(&full[s], (it / kTcStages) & 1);
    const float* qh = stages + (size_t)s * kTcChunk;
    const float* ql = qh + kTcPiece;
    const bool first = kc % kTcFlush == 0;         // a sum starts from zero
    const bool last = kc % kTcFlush == kTcFlush - 1 || kc == KC - 1;   // ... and ends
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_wait<1>();                             // A[ks & 1] is free again
      // and two k-steps in, the last chunk's wgmmas are done: free its stage
      if (ks == 2 && !first && lane == 0) mbar_arrive(&empty[(it - 1) % kTcStages]);
      // fragment (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4):
      // chunk columns 8t + 2ks, 8t + 2ks, 8t + 2ks + 1, 8t + 2ks + 1
      const float x[4] = {cur[0][2 * ks], cur[1][2 * ks], cur[0][2 * ks + 1],
                          cur[1][2 * ks + 1]};
      const uint64_t dh = smem_desc(qh + 2 * ks * (kTcLbo / 4), kTcLbo, 128);
      const uint64_t dl = smem_desc(ql + 2 * ks * (kTcLbo / 4), kTcLbo, 128);
      const int sd = (!first || ks > 0) ? 1 : 0;
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          A[ks & 1][0][i] = tf32_rna(x[i]);
          A[ks & 1][1][i] = tf32_rna(x[i] - __uint_as_float(A[ks & 1][0][i]));
        }
        wgmma_fence();
        wgmma_tf32(acc, A[ks & 1][1], dh, sd);     // Wl . qh
        wgmma_tf32(acc, A[ks & 1][0], dl, 1);      // Wh . ql
        wgmma_tf32(acc, A[ks & 1][0], dh, 1);      // Wh . qh
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) A[ks & 1][0][i] = __float_as_uint(x[i]);  // exact
        wgmma_fence();
        wgmma_tf32(acc, A[ks & 1][0], dl, sd);     // W . ql
        wgmma_tf32(acc, A[ks & 1][0], dh, 1);      // W . qh
      }
      wgmma_commit();
    }
    if (last) {
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] = kc < kTcFlush ? acc[i] : tot[i] + acc[i];
    }
    if (kc == KC - 1) {                            // the tile's epilogue
      const int tile = blockIdx.x + (it / KC) * gridDim.x;
      const int nt = tile % NT, r0 = row_of(it);
      float sc[2];
      bool ok[2], live[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        const size_t pr = (size_t)row * a.rs;
        ok[h] = row < a.m;
        sc[h] = ok[h] && a.scales != nullptr ? a.scales[pr] : 1.f;
        live[h] = !ok[h] || a.valid == nullptr || a.valid[pr] != 0;
      }
#pragma unroll
      for (int j = 0; j < kTcQ / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int b = nt * kTcQ + 8 * j + 2 * t + c;
          if (b >= a.B) continue;
          float v[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            v[h] = a.scales != nullptr ? tot[4 * j + 2 * h + c] * sc[h] : tot[4 * j + 2 * h + c];
            if (!live[h]) v[h] = LEMUR_NEG;
          }
          if constexpr (!FILTER) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (ok[h]) a.out[(size_t)b * a.ldo + r0 + 8 * h] = v[h];
          } else {
            const float bound = __ldg(a.thr + b);
            const bool in0 = ok[0] && v[0] >= bound, in1 = ok[1] && v[1] >= bound;
            if (in0 || in1) {
              int at = atomicAdd(a.cnt + b, (int)in0 + (int)in1);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if (!(h == 0 ? in0 : in1)) continue;
                if (at < a.cap) {
                  a.buf_s[(size_t)b * a.cap + at] = v[h];
                  a.buf_p[(size_t)b * a.cap + at] = r0 + 8 * h;
                }
                ++at;
              }
            }
          }
        }
      }
    }
  }
}

// The W loads' width: 16 bytes (fp32) or 8 (int8) when a row's chunks are
// whole and aligned, else one value at a time.
template <typename T>
inline int tc_vectorized(const T* W, int D) {
  const int align = sizeof(T) == 4 ? 16 : 8;
  return D % kTcK == 0 && reinterpret_cast<uintptr_t>(W) % align == 0;
}

template <typename T, bool FILTER>
static int launch_tc_scan(TcScan a, cudaStream_t stream) {
  if (a.B <= 0 || a.m <= 0) return (int)cudaSuccess;
  a.vec = tc_vectorized(static_cast<const T*>(a.W), a.D);
  cudaError_t err = allow_smem(tc_scan_kernel<T, FILTER>, kTcSmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((a.m + kTcRows - 1) / kTcRows) * tc_query_tiles(a.B);
  const int grid = (int)(tiles < sms ? tiles : sms);
  tc_scan_kernel<T, FILTER><<<grid, kTcThreads, kTcSmem, stream>>>(a);
  return (int)cudaGetLastError();
}
