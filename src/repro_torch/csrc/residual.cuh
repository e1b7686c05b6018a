// The residual codec on the card, shared by the three kernels of the
// compressed tier: ivf_probe_res_scan.cu, rerank_paged_res.cu and the
// residual entry of query_fused.cu.
//
// Packed layout (src/repro_torch/anns/quantization.py): per = 8 / BITS codes
// a byte, dimension i * per + j at bit BITS * j of byte i.  A decoded element
// is centroid[k] + values[k][code]: one fp32 add, the host decoder's
// arithmetic (quantization.residual_decode), so it has the host decoder's
// bits wherever a kernel forms it (the CUDA-core rerank's pages).  The TPU
// kernels reach the same value through a select-sum over the levels and a
// one-hot product for the centroid row, because Mosaic has no dynamic
// gather; here an indexed load does it.
//
// The scans never form it.  A row of list c scores
//   q . c + sum_k q[k] values[k][code_k]
// (res_scan below): the first term is one dot a probe (res_list_dot), the
// second a lookup a code in a table of q[k] values[k][l] that depends on
// the query and not on the list, so a block scores rows of any of its
// lists against one table.  It differs from q . decode(row) by fp32
// rounding (the plain versions decode, then score).  res_scan is
// query_fused_res's scorer, one query a block: bounded by the lookups'
// instructions (a shift, a lookup and an add a code: a floor of about 0.8
// ms for 256 queries x 12,471 rows x 2,048 codes at 32 lookups a clock an
// SM), it walks only live slots, keeps the next group's words in flight
// while it sums a group, and builds the table once a chunk of up to 2,048
// rows of any list.  ivf_probe_res_scan groups the (query, probe) pairs by
// list instead and sums the same terms in the same order with the values
// table in shared memory, each lookup serving up to 4 queries
// (ivf_probe_res_scan.cu), so both residual routes score a row alike.
#pragma once

#include "common.cuh"

template <int BITS>
struct ResCodes {
  static_assert(BITS == 2 || BITS == 4, "the codec packs 2 or 4 bits");
  static constexpr int kPer = 8 / BITS;       // codes a byte
  static constexpr int kLevels = 1 << BITS;   // values a dimension
  // code j of a packed byte, or of a little-endian word of them
  __device__ static __forceinline__ int code(uint32_t packed, int j) {
    return (packed >> (BITS * j)) & (kLevels - 1);
  }
};

__device__ __forceinline__ float res_decode(float centroid, float value) {
  return centroid + value;
}

// Scoring residual rows against a query, by a whole block of kResThreads
// threads (the one-launch query scores this way; the probe scan by list
// reproduces its sums, so a row gets the same bits in both).
constexpr int kResThreads = 256;
constexpr int kResWarps = kResThreads / 32;
constexpr int kResRowsPerWarp = 16;                     // rows a warp scores at once
constexpr int kResGroup = kResWarps * kResRowsPerWarp;  // rows the block scores at once
constexpr int kResChunk = 2048;                         // live rows gathered before scoring
constexpr int kResChunkCap = kResChunk + kResWarps * 32;  // a warp adds up to 32 past it
constexpr int kResTileDims = 512;                       // dims a tile of the walk
constexpr int kResTileStride = 544;  // a level's row: 512 dims, a pad after every 32,
                                     // rounded up to whole banks

// The shared-memory column of tile dim kk: one pad word after every 32, so
// that lane l reading the dims of word l + 32 t hits its own bank.
__device__ __forceinline__ int res_col(int kk) { return kk + (kk >> 5); }

// Floats of shared memory res_scan works in: the tile's table, the chunk's
// sums, then its rows' (q . c, output index, row index) and the count.
inline size_t res_smem_floats(int bits) {
  return (size_t)(1 << bits) * kResTileStride + 4 * (size_t)kResChunkCap + 4;
}

// q . c of a list's centroid row, by one warp: lane l sums dims l, l + 32,
// ... with fmaf in order, then the butterfly; the same bits in every lane
// and in every kernel.
__device__ __forceinline__ float res_list_dot(const float* q, const float* __restrict__ c,
                                              int D, int lane) {
  float s = 0.f;
  for (int k = lane; k < D; k += 32) s = fmaf(q[k], __ldg(c + k), s);
  return warp_sum(s);
}

// One tile's rows when a packed row is not whole 4-byte words (D not a
// multiple of 32 / BITS; res_score_rows below, WHOLE false): a lane
// assembles its words from single bytes, none past the row, and leaves out
// the codes past the tile's nk dims (the last word of a row).  The sums run
// in the order of the whole-word walk.
template <int BITS>
__device__ __forceinline__ void res_tile_rows_bytes(const uint8_t* __restrict__ codes,
                                                    const int* e_row, int n, int k0, int nk,
                                                    int db, const float* T, float* acc) {
  using RC = ResCodes<BITS>;
  constexpr int cpw = 32 / BITS;                         // codes a word
  constexpr int kWords = kResTileDims / cpw / 32;        // words a lane a row a tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tw = (nk + cpw - 1) / cpw;                   // words of the tile a row
  const int tb = k0 / cpw * 4;                           // the tile's first byte in a row
  for (int g = 0; g < n; g += kResGroup) {
    const uint8_t* row[kResRowsPerWarp];
    float part[kResRowsPerWarp];
    uint32_t w[kResRowsPerWarp][kWords];
#pragma unroll
    for (int h = 0; h < kResRowsPerWarp; ++h) {
      const int i = g + warp + kResWarps * h;
      row[h] = i < n ? codes + (size_t)e_row[i] * db + tb : nullptr;
      part[h] = 0.f;
#pragma unroll
      for (int t = 0; t < kWords; ++t) {
        const int wi = lane + 32 * t;
        uint32_t x = 0u;
        if (row[h] != nullptr && wi < tw) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (tb + 4 * wi + j < db) x |= (uint32_t)__ldg(row[h] + 4 * wi + j) << (8 * j);
        }
        w[h][t] = x;
      }
    }
#pragma unroll
    for (int h = 0; h < kResRowsPerWarp; ++h) {
      if (row[h] == nullptr) continue;       // past the chunk (warp-uniform)
#pragma unroll
      for (int t = 0; t < kWords; ++t) {
        const int wi = lane + 32 * t;
        if (wi >= tw) continue;              // past a short last tile
#pragma unroll
        for (int j = 0; j < cpw; ++j)
          if (wi * cpw + j < nk)
            part[h] += T[RC::code(w[h][t], j) * kResTileStride + res_col(wi * cpw + j)];
      }
    }
#pragma unroll
    for (int h = 0; h < kResRowsPerWarp; ++h) {
      const float s = warp_sum(part[h]);
      const int i = g + warp + kResWarps * h;
      if (lane == 0 && i < n) acc[i] += s;
    }
  }
}

// Whether res_scan may load codes (rows, D * bits / 8) a whole 4-byte word
// at a time: every row whole words, the codes aligned.
inline bool res_whole_words(const void* codes, int D, int bits) {
  return D * bits / 8 % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0;
}

// acc[i] = sum over d's tiles of a warp sum of row e_row[i]'s lookups, for
// the chunk's n rows: d is walked in tiles of 512 dims, and for each tile
// the block writes q[k] values[k][l] for every level l to shared memory
// (34 KB at 4 bits, read coalesced from L2 once a tile a chunk); a warp's
// 16 rows arrive as 4-byte words, all in flight together, and each code
// then costs a shift, one lookup and one add, lanes on their own banks (the
// table's columns are padded).
template <int BITS, bool WHOLE>
__device__ __forceinline__ void res_score_rows(const uint8_t* __restrict__ codes,
                                               const int* e_row, int n, const float* q,
                                               const float* __restrict__ values, int D,
                                               float* T, float* acc) {
  using RC = ResCodes<BITS>;
  constexpr int L = RC::kLevels;
  constexpr int cpw = 32 / BITS;                         // codes a word
  constexpr int kWords = kResTileDims / cpw / 32;        // words a lane a row a tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wpr = D / cpw;                               // words a row (WHOLE)
  const uint32_t* words = reinterpret_cast<const uint32_t*>(codes);
  for (int i = tid; i < n; i += kResThreads) acc[i] = 0.f;
  for (int k0 = 0; k0 < D; k0 += kResTileDims) {
    const int nk = min(kResTileDims, D - k0);
    __syncthreads();                        // the previous tile is read, acc is zeroed
    for (int kk = tid; kk < nk; kk += kResThreads) {
      const int k = k0 + kk;
      const float qk = q[k];
      const float4* v4 = reinterpret_cast<const float4*>(values + (size_t)k * L);
#pragma unroll
      for (int l4 = 0; l4 < L / 4; ++l4) {
        const float4 v = __ldg(v4 + l4);
        T[(4 * l4 + 0) * kResTileStride + res_col(kk)] = qk * v.x;
        T[(4 * l4 + 1) * kResTileStride + res_col(kk)] = qk * v.y;
        T[(4 * l4 + 2) * kResTileStride + res_col(kk)] = qk * v.z;
        T[(4 * l4 + 3) * kResTileStride + res_col(kk)] = qk * v.w;
      }
    }
    __syncthreads();
    if constexpr (!WHOLE) {
      res_tile_rows_bytes<BITS>(codes, e_row, n, k0, nk, D * BITS / 8, T, acc);
      continue;
    }
    const int tw = nk / cpw;                // words of the tile a row
    // a group's 16 rows a warp as 4-byte words, 0 past the chunk or the tile
    auto fetch = [&](int g, uint32_t (&w)[kResRowsPerWarp][kWords]) {
#pragma unroll
      for (int h = 0; h < kResRowsPerWarp; ++h) {
        const int i = g + warp + kResWarps * h;
        const uint32_t* row = words + (size_t)(i < n ? e_row[i] : 0) * wpr + k0 / cpw;
#pragma unroll
        for (int t = 0; t < kWords; ++t) {
          const int wi = lane + 32 * t;
          w[h][t] = i < n && wi < tw ? __ldg(row + wi) : 0u;
        }
      }
    };
    uint32_t w[kResRowsPerWarp][kWords];
    fetch(0, w);
    for (int g = 0; g < n; g += kResGroup) {
      // the next group's words are in flight while this group is summed
      uint32_t wn[kResRowsPerWarp][kWords];
      fetch(g + kResGroup, wn);
      float part[kResRowsPerWarp];
#pragma unroll
      for (int h = 0; h < kResRowsPerWarp; ++h) {
        part[h] = 0.f;
        if (g + warp + kResWarps * h >= n) continue;   // past the chunk (warp-uniform)
#pragma unroll
        for (int t = 0; t < kWords; ++t) {
          const int wi = lane + 32 * t;
          if (wi >= tw) continue;           // past a short last tile
#pragma unroll
          for (int j = 0; j < cpw; ++j)
            part[h] += T[RC::code(w[h][t], j) * kResTileStride + res_col(wi * cpw + j)];
        }
      }
#pragma unroll
      for (int h = 0; h < kResRowsPerWarp; ++h) {
        const float s = warp_sum(part[h]);
        const int i = g + warp + kResWarps * h;
        if (lane == 0 && i < n) acc[i] += s;
#pragma unroll
        for (int t = 0; t < kWords; ++t) w[h][t] = wn[h][t];
      }
    }
  }
  __syncthreads();
}

// The scan of a block: for units u = 0 .. nunits - 1 (list probe[u / nseg],
// slots [cap (u % nseg) / nseg, cap (u % nseg + 1) / nseg)), out[(u / nseg)
// cap + slot] = the score of each live slot (id >= 0) whose rank among its
// list's live slots is rr mod R, and -inf at each pad slot = rr mod R (an
// invalid probe: every slot a pad).  Only live rows are read: warp w walks
// units w, w + 8, ... 32 slots at a time, a ballot finds the live ones and
// they join the chunk (row, q . c, output index) through one shared
// counter; when it holds kResChunk rows or every unit is walked, the block
// scores the chunk (res_score_rows) and writes acc + q . c.  Rows of any
// list share a chunk: the table does not depend on the list.  R > 1 needs
// nseg == 1 (the ranks count through the whole list).
template <int BITS, bool WHOLE>
__device__ __forceinline__ void res_scan(const int* probe, int nunits, int nseg, int R, int rr,
                                         const float* q, const int* __restrict__ ids,
                                         const uint8_t* __restrict__ codes,
                                         const float* __restrict__ centroids,
                                         const float* __restrict__ values, float* out, int cap,
                                         int D, int nlist, float* sm) {
  float* T = sm;
  float* acc = T + ResCodes<BITS>::kLevels * kResTileStride;
  float* e_qc = acc + kResChunkCap;
  int* e_pos = reinterpret_cast<int*>(e_qc + kResChunkCap);
  int* e_row = e_pos + kResChunkCap;
  int* n_ent = e_row + kResChunkCap;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned lt = (1u << lane) - 1u;
  // the warp's cursor: unit, its list, next slot, end, live slots seen, q . c
  int u = warp - kResWarps, cl = -1, s0 = 0, s1 = 0, seen = 0;
  float qc = 0.f;
  bool walking = false, done = false;
  if (tid == 0) *n_ent = 0;
  __syncthreads();
  for (;;) {
    while (!done && *reinterpret_cast<volatile int*>(n_ent) < kResChunk) {
      if (!walking) {
        u += kResWarps;
        if (u >= nunits) {
          done = true;
          break;
        }
        const int p = u / nseg, sg = u - p * nseg;
        cl = probe[p];
        if (cl >= nlist) cl = -1;
        s0 = (int)((long long)cap * sg / nseg);
        s1 = (int)((long long)cap * (sg + 1) / nseg);
        seen = 0;
        qc = cl >= 0 ? res_list_dot(q, centroids + (size_t)cl * D, D, lane) : 0.f;
        walking = true;
      }
      // 4 steps of 32 slots: their ids in flight together, then taken in
      // order while the chunk has room
      const int p = u / nseg;
      int idv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int slot = s0 + 32 * i + lane;
        idv[i] = slot < s1 && cl >= 0 ? ids[(size_t)cl * cap + slot] : -1;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (s0 >= s1 || (i > 0 && *reinterpret_cast<volatile int*>(n_ent) >= kResChunk)) break;
        const int slot = s0 + lane;
        const bool in = slot < s1, live = in && idv[i] >= 0;
        const unsigned m = __ballot_sync(0xffffffffu, live);
        const bool mine = live && (seen + __popc(m & lt)) % R == rr;
        if (in && !live && slot % R == rr) out[(size_t)p * cap + slot] = -INFINITY;
        const unsigned mm = __ballot_sync(0xffffffffu, mine);
        if (mm) {
          int base = 0;
          if (lane == 0) base = atomicAdd(n_ent, __popc(mm));
          base = __shfl_sync(0xffffffffu, base, 0);
          if (mine) {
            const int e = base + __popc(mm & lt);
            e_row[e] = cl * cap + slot;
            e_pos[e] = p * cap + slot;
            e_qc[e] = qc;
          }
        }
        seen += __popc(m);
        s0 += 32;
      }
      walking = s0 < s1;
    }
    const int more = __syncthreads_or(!done);   // the chunk's rows are in
    const int n = *n_ent;
    if (n == 0 && !more) break;
    if (n > 0) {
      res_score_rows<BITS, WHOLE>(codes, e_row, n, q, values, D, T, acc);
      for (int i = tid; i < n; i += kResThreads) out[e_pos[i]] = acc[i] + e_qc[i];
    }
    __syncthreads();                        // the chunk is written
    if (tid == 0) *n_ent = 0;
    __syncthreads();
  }
}
