// psi(x) = LN(GELU_tanh(x W' + b)) and its masked query pool on Hopper:
// the kernel of fused_psi_pool.cu (the design and its costs are described
// there).
//
// A cluster of CS = ceil(d' / 256) blocks takes 64-row tiles of x; block
// `rank` owns d' columns [256 rank, 256 rank + 256), two tiles of 128, one
// a consumer warpgroup.  The product runs on the tensor cores (wgmma, the
// 3xTF32 split of tc_common.cuh: x's rows split in registers as A, W''s
// pieces in the B image of W'^T), W' streamed through a two-stage ring of
// 64 KB by bulk copies, the sums kept in registers.  Bias and GELU there;
// then each block's row sums and its squared deviations about its own row
// mean (two passes over the registers) go to the other blocks of the
// cluster by st.async, which counts their bytes on the receiver's mbarrier
// (no fence; buffers and barriers alternate by tile), and every block
// combines the blocks' (sum, M2) pairs in rank order (the same bits in
// every block) and normalises its own columns.  The pool adds mask_t * y
// over each query's rows, a warp's rows by shuffles, the four warps in
// order, a query's tiles in order, and writes each sum once: no atomics,
// the same bits from call to call.
#pragma once

#include <cooperative_groups.h>

#include "tc_common.cuh"

constexpr int kPsiRows = 64;                      // rows of a tile (wgmma's M)
constexpr int kPsiTileCols = 128;                 // columns of a warpgroup (wgmma's N)
constexpr int kPsiBlockCols = 2 * kPsiTileCols;   // a block's columns of d'
constexpr int kPsiMaxCluster = 16;                // blocks of a cluster: d' <= 4096
constexpr int kPsiMaxDp = kPsiMaxCluster * kPsiBlockCols;
constexpr int kPsiStages = 2;                     // stages of the W' ring
constexpr int kPsiPiece = kPsiTileCols * kTcK;    // floats of a piece of a (tile, chunk)
constexpr int kPsiChunk = 2 * kPsiPiece;          // (hi, lo) of a (tile, chunk): 32 KB
constexpr int kPsiStage = 2 * kPsiChunk;          // both warpgroups' chunks: 64 KB
constexpr int kPsiLbo = kPsiTileCols / 8 * 128;   // bytes between a k-step's column halves
constexpr bool kPsiStats = true;                  // the LayerNorm statistics (ablation)
static_assert(kTcConsumers == kPsiBlockCols, "a consumer thread a column of the block");

constexpr size_t kPsiSmem =
    ((size_t)kPsiStages * kPsiStage                      // the W' ring
     + (size_t)kTcWStages * kTcConsumers * kTcWSlot      // the A slots
     + 8 * kPsiRows                                      // part: [tile & 1][S, M2][warpgroup][row]
     + 4 * kPsiMaxCluster * kPsiRows                     // xch: [tile & 1][S, M2][rank][row]
     + 2 * 4 * kPsiTileCols                              // wsum: [warpgroup][warp][column]
     + 3 * kPsiBlockCols) * sizeof(float)                // bias, gamma, beta of the block
    + (2 * kPsiStages + 2) * 8;                          // full, empty, xbar

// GELU_tanh(x) = 0.5 x (1 + tanh(u)) = x / (1 + exp(-2u)), u = sqrt(2 / pi)
// (x + 0.044715 x^3): one exponential and one division, no branch (tanhf
// takes two paths by |u|); the same function up to fp32 rounding.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float u = 0.7978845608028654f * fmaf(0.044715f * x, x * x, x);
  return __fdividef(x, 1.f + __expf(-2.f * u));
}

struct PsiArgs {
  const float* x;         // (n, D)
  const uint8_t* mask;    // (n,) or null: every row counts (pool)
  const float* img;       // W'^T's split pieces (tc_image, N = kPsiTileCols)
  const float* bias;      // (Dp,)
  const float* gamma;     // (Dp,)
  const float* beta;      // (Dp,)
  float* out;             // (n, Dp), or (n / seg, Dp) pooled
  int n, seg, D, Dp, pool, vec;
  int NT, KC, CS;         // column tiles, chunks of D, blocks a cluster
  int per, tiles, items;  // segments an item (seg <= 64), tiles an item, items
  float eps;
};

// The rows of tile k of work item `item`: seg <= 64, `per` whole segments
// in one tile; else one segment over `tiles` tiles.
__device__ __forceinline__ void psi_tile(const PsiArgs& a, int item, int k, int& row0,
                                         int& rows) {
  if (a.seg <= kPsiRows) {
    row0 = item * a.per * a.seg;
    rows = min(a.per * a.seg, a.n - row0);
  } else {
    row0 = item * a.seg + k * kPsiRows;
    rows = min(kPsiRows, a.seg - k * kPsiRows);
  }
}

__device__ __forceinline__ uint32_t psi_remote(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// An asynchronous 16-byte store into a block of the cluster that counts its
// bytes on that block's mbarrier (no fence: a release arrival a block would
// cost a GPU-wide memory barrier each).
__device__ __forceinline__ void psi_st4_remote(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void psi_wait_cluster(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "PSI_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra PSI_DONE;\n"
      "bra PSI_WAIT;\n"
      "PSI_DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void psi_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The sum of a row's values in the 4 threads of a quad (the same bits in each).
__device__ __forceinline__ float psi_quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ void __launch_bounds__(kTcThreads, 1) psi_kernel(const PsiArgs a) {
  extern __shared__ __align__(128) float psi_sm[];
  float* stages = psi_sm;
  float* wring = stages + kPsiStages * kPsiStage;
  float* part = wring + kTcWStages * kTcConsumers * kTcWSlot;
  float* xch = part + 8 * kPsiRows;
  float* wsum = xch + 4 * kPsiMaxCluster * kPsiRows;
  float* prm = wsum + 2 * 4 * kPsiTileCols;      // [bias, gamma, beta][block column]
  uint64_t* full = reinterpret_cast<uint64_t*>(prm + 3 * kPsiBlockCols);
  uint64_t* empty = full + kPsiStages;
  uint64_t* xbar = empty + kPsiStages;           // [tile & 1]: the other blocks' partials are in
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int KC = a.KC, CS = a.CS;
  const int rank = blockIdx.x % CS, cid = blockIdx.x / CS, nclu = gridDim.x / CS;
  const int my_items = a.items > cid ? (a.items - 1 - cid) / nclu + 1 : 0;
  const int steps = my_items * a.tiles * KC;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kPsiStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcConsumers / 32);   // lane 0 of each consumer warp
    }
    mbar_init(&xbar[0], 1);                      // the local expect_tx; the others' bytes
    mbar_init(&xbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cooperative_groups::this_cluster().sync();     // every block's barriers are set up

  if (warp >= kTcConsumers / 32) {               // the producer warpgroup: one thread
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kTcConsumers) {
      const int nt0 = 2 * rank, here = min(2, a.NT - nt0);
      for (int it = 0; it < steps; ++it) {
        const int s = it % kPsiStages, kc = it % KC;
        if (it >= kPsiStages) mbar_wait(&empty[s], ((it / kPsiStages) - 1) & 1);
        const bool copy = true;   // every tile's chunks
        if (copy) {
          mbar_expect_tx(&full[s], here * kPsiChunk * sizeof(float));
          for (int w = 0; w < here; ++w)
            bulk_copy_g2s(stages + (size_t)s * kPsiStage + w * kPsiChunk,
                          a.img + ((size_t)(nt0 + w) * KC + kc) * kPsiChunk,
                          kPsiChunk * sizeof(float), &full[s]);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, t = lane & 3;
  const int ct = threadIdx.x & 127;              // the thread's column in the pool
  const int nt = 2 * rank + wg;
  const bool has = nt < a.NT;                    // the warpgroup has columns
  const int lr0 = 16 * wi + g;                   // its rows lr0, lr0 + 8 of a tile
  {  // the block's columns of bias, gamma and beta, once (0 past d')
    const int col = rank * kPsiBlockCols + threadIdx.x;
    const bool ok = col < a.Dp;
    prm[threadIdx.x] = ok ? a.bias[col] : 0.f;
    prm[kPsiBlockCols + threadIdx.x] = ok ? a.gamma[col] : 0.f;
    prm[2 * kPsiBlockCols + threadIdx.x] = ok ? a.beta[col] : 0.f;
    psi_sync(1, kTcConsumers);
  }
  float acc[64], tot[64];                        // the chunk's sum, the running total
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
  float cur[2][8];
  uint32_t A[2][2][4];                           // [k-step & 1][hi, lo][register]
  auto item_of = [&](int u) { return cid + (u / a.tiles) * nclu; };
  auto slot_of = [&](int it) {
    return wring + ((size_t)(it % kTcWStages) * kTcConsumers + threadIdx.x) * kTcWSlot;
  };
  auto fetch = [&](int it) {
    const int u = it / KC, k0 = (it % KC) * kTcK + 8 * t;
    int row0, rows;
    psi_tile(a, item_of(u), u % a.tiles, row0, rows);
    const float* p[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ok[h] = lr0 + 8 * h < rows;
      p[h] = ok[h] ? a.x + (size_t)(row0 + lr0 + 8 * h) * a.D + k0 : a.x;
    }
    tc_fetch_rows<float>(p, ok, k0, a.D, a.vec, slot_of(it));
  };
#pragma unroll
  for (int i = 0; i < kTcWStages - 1; ++i) {
    if (i < steps) fetch(i);
    else cp_async_commit();
  }
  int xph = 0;                                   // tiles exchanged: buffer, barrier, parity
  float run = 0.f;                               // a long query's pool, column ct
  for (int it = 0; it < steps; ++it) {
    const int kc = it % KC, s = it % kPsiStages;
    const int ahead = it + kTcWStages - 1;         // its slot was read last step
    if (ahead < steps) fetch(ahead);
    else cp_async_commit();
    cp_async_wait<kTcWStages - 1>();               // chunk it has landed
    tc_read<float>(slot_of(it), cur);
    mbar_wait(&full[s], (it / kPsiStages) & 1);
    const float* wh = stages + (size_t)s * kPsiStage + wg * kPsiChunk;
    const float* wl = wh + kPsiPiece;
    const bool first = kc % kTcFlush == 0;         // a sum starts from zero
    const bool last = kc % kTcFlush == kTcFlush - 1 || kc == KC - 1;   // ... and ends
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_wait<1>();                             // A[ks & 1] is free again
      // and two k-steps in, the last chunk's wgmmas are done: free its stage
      if (ks == 2 && !first && lane == 0) mbar_arrive(&empty[(it - 1) % kPsiStages]);
      if (!has) continue;
      // fragment (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4):
      // chunk columns 8t + 2ks, 8t + 2ks, 8t + 2ks + 1, 8t + 2ks + 1
      const float xv[4] = {cur[0][2 * ks], cur[1][2 * ks], cur[0][2 * ks + 1],
                           cur[1][2 * ks + 1]};
      const uint64_t dh = smem_desc(wh + 2 * ks * (kPsiLbo / 4), kPsiLbo, 128);
      const uint64_t dl = smem_desc(wl + 2 * ks * (kPsiLbo / 4), kPsiLbo, 128);
      const int sd = (!first || ks > 0) ? 1 : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        A[ks & 1][0][i] = tf32_rna_int(xv[i]);
        A[ks & 1][1][i] = tf32_rna_int(xv[i] - __uint_as_float(A[ks & 1][0][i]));
      }
      wgmma_fence();
      wgmma_tf32(acc, A[ks & 1][1], dh, sd);     // xl . Wh
      wgmma_tf32(acc, A[ks & 1][0], dl, 1);      // xh . Wl
      wgmma_tf32(acc, A[ks & 1][0], dh, 1);      // xh . Wh
      wgmma_commit();
    }
    if (last) {
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] = kc < kTcFlush ? acc[i] : tot[i] + acc[i];
    }
    if (kc != KC - 1) continue;

    // -- the tile's epilogue: thread value i is row lr0 + 8 ((i >> 1) & 1),
    //    column nt 128 + 8 (i >> 2) + 2 t + (i & 1) ---------------------------
    const int u = it / KC, item = item_of(u), k = u % a.tiles;
    int row0, rows;
    psi_tile(a, item, k, row0, rows);
    // columns past d' (and a warpgroup without columns) hold 0 (W''s image
    // and the staged parameters are 0 there), and GELU(0) = 0: no branch
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float b = prm[wg * kPsiTileCols + 8 * j + 2 * t + c];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + c;
          tot[i] = gelu_tanh(tot[i] + b);
          rs[h] += tot[i];
        }
      }
    float mean[2] = {0.f, 0.f}, rstd[2] = {1.f, 1.f};
    if constexpr (kPsiStats) {
      // The block's columns: their row sums (pass 1), then the squared
      // deviations about the block's own row mean (pass 2), both over the
      // registers; one exchange of each block's (sum, M2) through the
      // cluster, combined by every block in rank order:
      //   mean = sum_b S_b / d',  var = sum_b (M2_b + n_b (S_b / n_b - mean)^2) / d'
      // (Chan et al.'s pairwise update: the two-pass variance, one round trip).
      const int ex = xph & 1;                      // this tile's buffer and barrier
      float* xb = xch + ex * 2 * kPsiMaxCluster * kPsiRows;    // [S, M2][rank][row]
      float* pt = part + ex * 4 * kPsiRows;                    // [S, M2][warpgroup][row]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] = psi_quad_sum(rs[h]);
        if (t == 0) pt[wg * kPsiRows + lr0 + 8 * h] = rs[h];
      }
      psi_sync(1, kTcConsumers);                   // both warpgroups' sums are in
      const float nb = (float)min(kPsiBlockCols, a.Dp - rank * kPsiBlockCols);
      float bm[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lr0 + 8 * h;
        bm[h] = (pt[r] + pt[kPsiRows + r]) / nb;
        rs[h] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool ok = has && nt * kPsiTileCols + 8 * j + 2 * t + c < a.Dp;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float dv = ok ? tot[4 * j + 2 * h + c] - bm[h] : 0.f;
            rs[h] = fmaf(dv, dv, rs[h]);
          }
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] = psi_quad_sum(rs[h]);
        if (t == 0) pt[(2 + wg) * kPsiRows + lr0 + 8 * h] = rs[h];
      }
      if (threadIdx.x == 0)                        // the other blocks' bytes of this tile
        mbar_expect_tx(&xbar[ex], (CS - 1) * 2 * kPsiRows * sizeof(float));
      psi_sync(1, kTcConsumers);                   // both warpgroups' deviations are in
      if (threadIdx.x < kPsiRows / 2) {            // S (tid < 16) or M2 of rows
        // 4 (tid % 16) .. + 3, to every other block of the cluster
        const int w = threadIdx.x / (kPsiRows / 4), r4 = threadIdx.x % (kPsiRows / 4);
        const float4 p0 = reinterpret_cast<const float4*>(pt + 2 * w * kPsiRows)[r4];
        const float4 p1 = reinterpret_cast<const float4*>(pt + (2 * w + 1) * kPsiRows)[r4];
        const float4 v = make_float4(p0.x + p1.x, p0.y + p1.y, p0.z + p1.z, p0.w + p1.w);
        float* dst = xb + (w * kPsiMaxCluster + rank) * kPsiRows + 4 * r4;
        for (int q = 0; q < CS; ++q)
          if (q != rank) psi_st4_remote(psi_remote(dst, q), v, psi_remote(&xbar[ex], q));
      }
      psi_wait_cluster(&xbar[ex], (xph >> 1) & 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lr0 + 8 * h;
        auto sum_of = [&](int q) {                 // block q's row sum
          return q == rank ? pt[r] + pt[kPsiRows + r] : xb[q * kPsiRows + r];
        };
        float s = 0.f;
        for (int q = 0; q < CS; ++q) s += sum_of(q);
        mean[h] = s / (float)a.Dp;
        float m2 = 0.f;
        for (int q = 0; q < CS; ++q) {
          const float nq = (float)min(kPsiBlockCols, a.Dp - q * kPsiBlockCols);
          const float dq = sum_of(q) / nq - mean[h];
          const float mq = q == rank ? pt[2 * kPsiRows + r] + pt[3 * kPsiRows + r]
                                     : xb[(kPsiMaxCluster + q) * kPsiRows + r];
          m2 += fmaf(nq * dq, dq, mq);
        }
        rstd[h] = 1.f / sqrtf(m2 / (float)a.Dp + a.eps);
      }
      ++xph;
    }
    // normalise: y = (h - mean) rstd gamma + beta (0 past d': gamma and beta
    // are), each row once, or pooled
    float mk[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = lr0 + 8 * h;
      mk[h] = lr >= rows ? 0.f
              : (a.pool && a.mask != nullptr) ? (float)(a.mask[row0 + lr] != 0) : 1.f;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = nt * kPsiTileCols + 8 * j + 2 * t + c;
        const bool ok = has && col < a.Dp;
        const float gm = prm[kPsiBlockCols + wg * kPsiTileCols + 8 * j + 2 * t + c];
        const float bt = prm[2 * kPsiBlockCols + wg * kPsiTileCols + 8 * j + 2 * t + c];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + c, lr = lr0 + 8 * h;
          const float y = (tot[i] - mean[h]) * rstd[h] * gm + bt;
          if (!a.pool) {
            if (ok && lr < rows) a.out[(size_t)(row0 + lr) * a.Dp + col] = y;
          } else {
            tot[i] = y * mk[h];                      // mk 0 past the tile's rows
          }
        }
      }
    if (!a.pool) continue;
    // the pool: each segment of the tile, a warp's rows by shuffles (rows g
    // and g + 8 of a thread, then the 8 lanes of a column), the 4 warps in
    // order, a long query's tiles in order
    const int slen = a.seg <= kPsiRows ? a.seg : rows;
    const int nseg = a.seg <= kPsiRows ? rows / a.seg : 1;
    float* ws = wsum + wg * 4 * kPsiTileCols;
    for (int sg = 0; sg < nseg; ++sg) {
      const int ra = sg * slen, rb = ra + slen;
      const bool in0 = lr0 >= ra && lr0 < rb, in1 = lr0 + 8 >= ra && lr0 + 8 < rb;
      if (16 * wi < rb && 16 * wi + 16 > ra) {   // the warp has rows in the segment
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float v = (in0 ? tot[4 * j + c] : 0.f) + (in1 ? tot[4 * j + 2 + c] : 0.f);
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (g == 0) ws[wi * kPsiTileCols + 8 * j + 2 * t + c] = v;
          }
      } else if (g == 0) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) ws[wi * kPsiTileCols + 8 * j + 2 * t + c] = 0.f;
      }
      psi_sync(2 + wg, 128);                       // the warpgroup's 4 warps are in
      const int col = nt * kPsiTileCols + ct;
      const float v = ws[ct] + ws[kPsiTileCols + ct] + ws[2 * kPsiTileCols + ct] +
                      ws[3 * kPsiTileCols + ct];
      if (a.seg <= kPsiRows) {
        if (has && col < a.Dp) a.out[(size_t)(item * a.per + sg) * a.Dp + col] = v;
      } else {
        run = k == 0 ? v : run + v;
        if (k == a.tiles - 1 && has && col < a.Dp) a.out[(size_t)item * a.Dp + col] = run;
      }
      psi_sync(2 + wg, 128);                       // ws is read
    }
  }
}

// Floats of the W' image the kernel streams (D, Dp).
inline long long psi_image_floats(int D, int Dp) {
  return (long long)((Dp + kPsiTileCols - 1) / kPsiTileCols) * tc_chunks(D) * kPsiChunk;
}

// The image of W' (D, Dp), then the kernel over n rows: segments of seg
// rows pooled (pool != 0; n a multiple of seg) or every row written.
// static, not inline: its static locals stay this library's (an inline
// function's are one object across every library the process loads).
static int launch_fused_psi(const float* x, const uint8_t* mask, const float* W,
                            const float* bias, const float* gamma, const float* beta,
                            float* out, float* img, int n, int seg, int D, int Dp, int pool,
                            float eps, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (Dp < 1 || Dp > kPsiMaxDp || D < 1 || seg < 1) return (int)cudaErrorInvalidValue;
  int err = launch_tc_image<kPsiTileCols, true>(W, img, 1, Dp, D, stream);
  if (err != 0) return err;
  PsiArgs a{};
  a.x = x;
  a.mask = mask;
  a.img = img;
  a.bias = bias;
  a.gamma = gamma;
  a.beta = beta;
  a.out = out;
  a.n = n;
  a.seg = pool ? seg : kPsiRows;
  a.D = D;
  a.Dp = Dp;
  a.pool = pool;
  a.vec = D % kTcK == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.eps = eps;
  a.NT = (Dp + kPsiTileCols - 1) / kPsiTileCols;
  a.KC = tc_chunks(D);
  a.CS = (a.NT + 1) / 2;
  if (a.seg <= kPsiRows) {
    a.per = kPsiRows / a.seg;
    a.tiles = 1;
    a.items = (n + a.per * a.seg - 1) / (a.per * a.seg);
  } else {
    a.per = 1;
    a.tiles = (a.seg + kPsiRows - 1) / kPsiRows;
    a.items = n / a.seg;
  }
  static bool ready = false, wide = false;       // the kernel's attributes, once
  cudaError_t e = cudaSuccess;
  if (!ready) {
    e = allow_smem(psi_kernel, kPsiSmem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  if (a.CS > 8 && !wide) {                       // clusters past the portable 8
    e = cudaFuncSetAttribute(psi_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    wide = true;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kTcThreads, 1, 1);
  cfg.dynamicSmemBytes = kPsiSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the clusters the card holds at once (asked once a cluster size): one
  // persistent cluster each, walking items cid, cid + clusters, ...
  static int resident[kPsiMaxCluster + 1] = {};
  if (resident[a.CS] == 0) {
    cfg.gridDim = dim3(a.CS, 1, 1);
    e = cudaOccupancyMaxActiveClusters(&resident[a.CS], psi_kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (resident[a.CS] < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const int clusters = a.items < resident[a.CS] ? a.items : resident[a.CS];
  cfg.gridDim = dim3(clusters * a.CS, 1, 1);
  e = cudaLaunchKernelEx(&cfg, psi_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
