// The dense latent product q . W^T on Hopper's tensor cores, for the dense
// scan's passes (query_fused.cu: mips_topk) and the all-pairs SQ8 scan
// (mips_sq8.cu).
//
// Numerics: an error-compensated split, so that the scores are those of an
// fp32 product up to fp32 rounding.  cvt.rna.tf32.f32 rounds a value to
// TF32 (11 significant bits); x = hi + lo with hi = rna(x), lo = rna(x -
// hi) leaves |x - hi - lo| <= 2^-22 |x|.  fp32 rows: 3xTF32, W.q = Wl.qh +
// Wh.ql + Wh.qh (the dropped Wl.ql is below 2^-22 of each term); SQ8 rows:
// the int8 codes are exact in TF32, so only q is split (2xTF32, W.ql +
// W.qh), and the row scale multiplies the sum afterwards.  Every product
// of two TF32 values is exact in fp32.  The tensor cores add in fp32 but
// do not round to nearest, so one accumulator's error grows with its
// adds (768 wgmmas over d' = 2048 at 3xTF32, well past an fp32 product's).
// So every kTcFlush chunks (64 columns) the tensor cores' sum starts from
// zero (24 or 16 wgmmas) and is then added to a running fp32 total with a
// rounded add, in column order.
// tests/test_torch_query_fused.py::test_tf32_split_error emulates this
// arithmetic on the CPU at d' = 2048 against an fp64 product; its bound,
// ref.TF32_SPLIT_RTOL, is the tolerance the card checks use.
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

#include "common.cuh"

constexpr int kTcRows = 128;                  // W rows of a tile
constexpr int kTcQ = 128;                     // queries of a tile
constexpr int kTcK = 32;                      // columns of a chunk
constexpr int kTcStages = 4;
constexpr int kTcPiece = kTcQ * kTcK;         // floats of one split piece of a chunk
constexpr int kTcChunk = 2 * kTcPiece;        // (qh, ql): 32 KB
constexpr int kTcLbo = kTcQ / 8 * 128;        // bytes between a k-step's column halves
constexpr int kTcFlush = 2;                   // chunks summed on the tensor cores at a time
constexpr int kTcConsumers = 256;             // two warpgroups
constexpr int kTcThreads = kTcConsumers + 128; // and the producer warpgroup
constexpr int kTcWStages = 4;                 // chunks of W a consumer has in flight
constexpr int kTcWSlot = 16;                  // floats of a consumer's chunk of W
constexpr size_t kTcSmem = ((size_t)kTcStages * kTcChunk +
                            (size_t)kTcWStages * kTcConsumers * kTcWSlot) * sizeof(float) +
                           2 * kTcStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// q's split pieces in the shared-memory image of every (query tile nt,
// chunk kc), chunk-major: element ((((nt KC + kc) 2 + piece) 8 + r) 16 + ng)
// 8 + n8) 4 + t holds piece (0: hi, 1: lo) of q[n][k], n = nt kTcQ + 8 ng +
// n8, k = kc kTcK + 8 t + r, 0 past B or D.
__global__ void tc_q_image_kernel(const float* __restrict__ q, float* __restrict__ img,
                                  int B, int D, int KC, long long total) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int t = (int)(e & 3), n8 = (int)((e >> 2) & 7), ng = (int)((e >> 5) & 15);
    const int r = (int)((e >> 9) & 7), piece = (int)((e >> 12) & 1);
    const long long chunk = e >> 13;
    const int kc = (int)(chunk % KC), nt = (int)(chunk / KC);
    const int n = nt * kTcQ + ng * 8 + n8, k = kc * kTcK + 8 * t + r;
    float v = 0.f;
    if (n < B && k < D) {
      const float x = q[(size_t)n * D + k];
      const float h = __uint_as_float(tf32_rna(x));
      v = piece == 0 ? h : __uint_as_float(tf32_rna(x - h));
    }
    img[e] = v;
  }
}

__host__ __device__ inline int tc_query_tiles(int B) { return (B + kTcQ - 1) / kTcQ; }
__host__ __device__ inline int tc_chunks(int D) { return (D + kTcK - 1) / kTcK; }

static int launch_tc_q_image(const float* q, float* img, int B, int D, cudaStream_t stream) {
  const int KC = tc_chunks(D);
  const long long total = (long long)tc_query_tiles(B) * KC * kTcChunk;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  tc_q_image_kernel<<<blocks, 256, 0, stream>>>(q, img, B, D, KC, total);
  return (int)cudaGetLastError();
}

// -- mbarriers, bulk copies, wgmma -------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of the accumulators across the
// asynchronous wgmmas (they are produced at wgmma_wait, not at the asm).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor, no swizzle: start address, LBO (bytes
// between the two 16-byte column groups of a k-step), SBO (bytes between
// 8-row groups), all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo & 0x3FFFF) >> 4) << 16;
  d |= (uint64_t)((sbo & 0x3FFFF) >> 4) << 32;
  return d;  // base offset 0, layout type 0 (no swizzle)
}

// d[64 x 128] (+)= a[64 x 8] . b[128 x 8]^T, TF32 in, fp32 accumulate;
// scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
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

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, bool pred) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(pred ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(pred ? 8 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Start copying a consumer thread's W values of one chunk into its slot:
// rows row0 and row0 + 8, columns 8t .. 8t + 7 of the chunk (fp32: 16
// floats; int8: 16 bytes), 0 past m or D.  Rows that are not whole aligned
// chunks are copied a value at a time by the thread itself.
template <typename T>
__device__ __forceinline__ void tc_fetch(const TcScan& a, int row0, int kc, int t, float* slot) {
  const T* W = static_cast<const T*>(a.W);
  const int k0 = kc * kTcK + 8 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool ok = row < a.m;
    const T* p = ok ? W + (size_t)row * a.rs * a.D + k0 : W;
    if (a.vec) {
      if constexpr (sizeof(T) == 4) {
        cp_async(slot + 8 * h, p, 16, ok);
        cp_async(slot + 8 * h + 4, p + 4, 16, ok);
      } else {
        cp_async(reinterpret_cast<uint8_t*>(slot) + 8 * h, p, 8, ok);
      }
    } else if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int j = 0; j < 8; ++j) slot[8 * h + j] = ok && k0 + j < a.D ? p[j] : 0.f;
    } else {
      uint8_t* sb = reinterpret_cast<uint8_t*>(slot) + 8 * h;
#pragma unroll
      for (int j = 0; j < 8; ++j) sb[j] = ok && k0 + j < a.D ? (uint8_t)p[j] : (uint8_t)0;
    }
  }
  cp_async_commit();
}

// Its values as floats, v[h][j]: row row0 + 8 h, column 8t + j.
template <typename T>
__device__ __forceinline__ void tc_read(const float* slot, float (&v)[2][8]) {
  if constexpr (sizeof(T) == 4) {
    const float4* s4 = reinterpret_cast<const float4*>(slot);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 x = s4[2 * h], y = s4[2 * h + 1];
      v[h][0] = x.x; v[h][1] = x.y; v[h][2] = x.z; v[h][3] = x.w;
      v[h][4] = y.x; v[h][5] = y.y; v[h][6] = y.z; v[h][7] = y.w;
    }
  } else {
    const uint4 x = *reinterpret_cast<const uint4*>(slot);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[h][j] = (float)(int8_t)((w[2 * h + j / 4] >> (8 * (j % 4))) & 0xff);
  }
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
