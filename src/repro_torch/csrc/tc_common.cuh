// The pieces of the TF32 tensor-core products that several kernels share:
// the dense latent scan (tc_scan.cuh: mips_topk, the all-pairs SQ8 scan) and
// the token MaxSim body (maxsim_tc.cuh: token_maxsim, rerank_gather_scores).
//
// Numerics: an error-compensated split, so that a score is that of an fp32
// product up to fp32 rounding.  cvt.rna.tf32.f32 rounds a value to TF32 (11
// significant bits); x = hi + lo with hi = rna(x), lo = rna(x - hi) leaves
// |x - hi - lo| <= 2^-22 |x|.  fp32 rows: 3xTF32, a.b = al.bh + ah.bl +
// ah.bh (the dropped al.bl is below 2^-22 of each term); int8 rows are exact
// in TF32, so only the other operand is split (2xTF32, a.bl + a.bh) and a
// scale multiplies the sum afterwards.  Every product of two TF32 values is
// exact in fp32.  The tensor cores add in fp32 but do not round to nearest,
// so every kTcFlush chunks (64 columns) their sum starts from zero and is
// then added to a running fp32 total with a rounded add, in column order.
// ref.tf32_split_scores emulates this arithmetic on the CPU; its bound,
// ref.TF32_SPLIT_RTOL, is the tolerance of the card checks.
//
// Operands: A (64 rows a warpgroup) from registers, split there; B from
// shared memory in wgmma's canonical K-major layout without swizzle, built
// beforehand in device memory by tc_image (8 x 16-byte core matrices, SBO
// 128 bytes between 8-row groups, LBO N / 8 x 128 bytes between the two
// 4-column halves of a k-step) and streamed a chunk of kTcK columns at a
// time by bulk copies.  So that a consumer thread's 8 values of an A row
// are contiguous, a chunk's columns are permuted: at k-step s of the chunk,
// fragment column c < 4 is column 8c + 2s and column c + 4 is 8c + 2s + 1;
// the image puts B's columns in the same places.
#pragma once

#include "common.cuh"

constexpr int kTcK = 32;                      // columns of a chunk
constexpr int kTcFlush = 2;                   // chunks summed on the tensor cores at a time
constexpr int kTcConsumers = 256;             // two warpgroups
constexpr int kTcThreads = kTcConsumers + 128; // and the producer warpgroup
constexpr int kTcWStages = 4;                 // chunks of A a consumer has in flight
constexpr int kTcWSlot = 16;                  // floats of a consumer's chunk of A

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// cvt.rna.tf32.f32 in integer arithmetic (half an ulp of the 10-bit
// mantissa added to the magnitude, the low 13 bits cleared: the same bits
// for normal values), two full-rate instructions where the conversion
// instruction issues at a quarter of the rate (16 a clock an SM); the
// MaxSim body splits every A value it multiplies.
__device__ __forceinline__ uint32_t tf32_rna_int(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// Signed byte j of w as a float, exactly: byte ^ 0x80 placed under the
// exponent of 2^23 (one byte permute), then 2^23 + 128 taken off (one
// add), where the int-to-float conversion issues at a quarter of the rate.
__device__ __forceinline__ float s8_to_float(uint32_t w_flipped, int j) {
  return __uint_as_float(__byte_perm(w_flipped, 0x4B000000u, 0x7540 + j)) - 8388736.f;
}

__host__ __device__ inline int tc_chunks(int D) { return (D + kTcK - 1) / kTcK; }

// The split pieces of groups of `rows` rows of src (D columns) in the B
// image, N rows a tile, chunk-major: element (((((((grp NT + nt) KC + kc) 2
// + piece) 8 + r) N/8 + ng) 8 + n8) 4 + t holds piece (0: hi, 1: lo) of
// src[grp rows + n][k], n = nt N + 8 ng + n8, k = kc kTcK + 8 t + r, 0 past
// rows or D.  A chunk is 2 N kTcK floats.  TRANS: src is stored (D, rows),
// element (n, k) at src[k rows + n] (one group).
template <int N, bool TRANS = false>
__global__ void tc_image_kernel(const float* __restrict__ src, float* __restrict__ img,
                                int rows, int NT, int D, int KC, long long total) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int t = (int)(e & 3), n8 = (int)((e >> 2) & 7);
    const long long u = e >> 5;
    const int ng = (int)(u % (N / 8));
    const long long v = u / (N / 8);
    const int r = (int)(v & 7), piece = (int)((v >> 3) & 1);
    const long long chunk = v >> 4;
    const int kc = (int)(chunk % KC);
    const long long tile = chunk / KC;
    const int nt = (int)(tile % NT);
    const long long grp = tile / NT;
    const int n = nt * N + ng * 8 + n8, k = kc * kTcK + 8 * t + r;
    float val = 0.f;
    if (n < rows && k < D) {
      const float x = TRANS ? src[(size_t)k * rows + n] : src[((size_t)grp * rows + n) * D + k];
      const float h = __uint_as_float(tf32_rna(x));
      val = piece == 0 ? h : __uint_as_float(tf32_rna(x - h));
    }
    img[e] = val;
  }
}

template <int N, bool TRANS = false>
static int launch_tc_image(const float* src, float* img, long long groups, int rows, int D,
                           cudaStream_t stream) {
  const int NT = (rows + N - 1) / N, KC = D > 0 ? tc_chunks(D) : 1;
  const long long total = groups * NT * KC * 2 * N * kTcK;
  if (total == 0) return (int)cudaSuccess;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  tc_image_kernel<N, TRANS><<<blocks, 256, 0, stream>>>(src, img, rows, NT, D, KC, total);
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
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// d[64 x N] (+)= a[64 x 8] . b[N x 8]^T, TF32 in, fp32 accumulate, N = 2 x
// the accumulators a thread; scale_d 0 overwrites d.  A thread's
// accumulator i holds row g + 8 ((i >> 1) & 1) of its warp's 16 and column
// 8 (i >> 2) + 2 t + (i & 1) (g = lane / 4, t = lane % 4).
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

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// -- the A operand: a consumer thread's rows, through its cp.async ring -------

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

// Start copying a consumer thread's A values of one chunk into its slot:
// 8 values of each of its two rows from p[h] (the row's element k0 of D;
// any readable address where !ok[h]), 0 where !ok[h] (nothing is read) or
// past D.  vec: 16-byte (fp32) / 8-byte (int8) copies, the rows' chunks
// whole and aligned; else the thread copies a value at a time.
template <typename T>
__device__ __forceinline__ void tc_fetch_rows(const T* const (&p)[2], const bool (&ok)[2],
                                              int k0, int D, bool vec, float* slot) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (vec) {
      if constexpr (sizeof(T) == 4) {
        cp_async(slot + 8 * h, p[h], 16, ok[h]);
        cp_async(slot + 8 * h + 4, p[h] + 4, 16, ok[h]);
      } else {
        cp_async(reinterpret_cast<uint8_t*>(slot) + 8 * h, p[h], 8, ok[h]);
      }
    } else if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int j = 0; j < 8; ++j) slot[8 * h + j] = ok[h] && k0 + j < D ? p[h][j] : 0.f;
    } else {
      uint8_t* sb = reinterpret_cast<uint8_t*>(slot) + 8 * h;
#pragma unroll
      for (int j = 0; j < 8; ++j) sb[j] = ok[h] && k0 + j < D ? (uint8_t)p[h][j] : (uint8_t)0;
    }
  }
  cp_async_commit();
}

// Its values as floats, v[h][j]: row h, column 8t + j of the chunk.
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

// The A registers of k-step ks of a chunk (rows g, g + 8, fragment columns
// t, t + 4: chunk columns 8t + 2ks, 8t + 2ks + 1): fp32 values split into
// (hi, lo), int8 values as they are (exact in TF32) in a[0].
template <typename T>
__device__ __forceinline__ void tc_split(const float (&v)[2][8], int ks, uint32_t (&a)[2][4]) {
  const float x[4] = {v[0][2 * ks], v[1][2 * ks], v[0][2 * ks + 1], v[1][2 * ks + 1]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      a[0][i] = tf32_rna_int(x[i]);
      a[1][i] = tf32_rna_int(x[i] - __uint_as_float(a[0][i]));
    } else {
      a[0][i] = __float_as_uint(x[i]);
    }
  }
}
