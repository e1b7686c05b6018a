// The residual codec's decoder on the card, shared by the three kernels of
// the compressed tier: ivf_probe_res_scan.cu, rerank_paged_res.cu and the
// residual entry of query_fused.cu.
//
// Packed layout (src/repro_torch/anns/quantization.py): per = 8 / BITS codes
// a byte, dimension i * per + j at bit BITS * j of byte i.  A decoded element
// is centroid[k] + values[k][code]: one fp32 add, the host decoder's
// arithmetic (quantization.residual_decode), so it has the host decoder's
// bits.  The TPU kernels reach the same value through a select-sum over the
// levels and a one-hot product for the centroid row, because Mosaic has no
// dynamic gather; here an indexed load does it.
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

// Scoring residual rows of one IVF list against a query, by a whole block
// of kResThreads threads (the probe scan and the one-launch query both score
// this way, so a row gets the same bits in both).
constexpr int kResThreads = 256;
constexpr int kResWarps = kResThreads / 32;
constexpr int kResRowsPerWarp = 16;                     // rows a warp scores at once
constexpr int kResGroup = kResWarps * kResRowsPerWarp;  // rows the block scores at once
constexpr int kResChunk = 1024;                         // rows a call scores
constexpr int kResTileDims = 512;                       // dims a tile of the walk
constexpr int kResTileStride = 544;  // a level's row: 512 dims, a pad after every 32,
                                     // rounded up to whole banks

// The shared-memory column of tile dim kk: one pad word after every 32, so
// that lane l reading the dims of word l + 32 t hits its own bank.
__device__ __forceinline__ int res_col(int kk) { return kk + (kk >> 5); }

// Floats of shared memory res_score_chunk works in: the tile's table, then
// the chunk's scores.
inline size_t res_smem_floats(int bits) {
  return (size_t)(1 << bits) * kResTileStride + kResChunk;
}

// One tile's rows [r0, r1) of a block's walk when a packed row is not
// whole 4-byte words (D not a multiple of 32 / BITS; res_score_chunk
// below, WHOLE false): a lane assembles its words from single bytes, none
// past the row, and leaves out the codes past the tile's nk dims (the last
// word of a row).  The sums run in the order of the whole-word walk.
template <int BITS>
__device__ __forceinline__ void res_tile_rows_bytes(const uint8_t* __restrict__ codes,
                                                    const int* __restrict__ ids, int r0, int r1,
                                                    int k0, int nk, int db, const float* T,
                                                    float* acc) {
  using RC = ResCodes<BITS>;
  constexpr int cpw = 32 / BITS;                         // codes a word
  constexpr int kWords = kResTileDims / cpw / 32;        // words a lane a row a tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tw = (nk + cpw - 1) / cpw;                   // words of the tile a row
  const int tb = k0 / cpw * 4;                           // the tile's first byte in a row
  for (int g = r0; g < r1; g += kResGroup) {
    int off[kResRowsPerWarp];
    float part[kResRowsPerWarp];
    uint32_t w[kResRowsPerWarp][kWords];
#pragma unroll
    for (int h = 0; h < kResRowsPerWarp; ++h) {
      const int r = g + warp + kResWarps * h;
      off[h] = (r < r1 && ids[r] >= 0) ? r * db + tb : -1;  // a list is under 2^31 bytes
      part[h] = 0.f;
#pragma unroll
      for (int t = 0; t < kWords; ++t) {
        const int wi = lane + 32 * t;
        uint32_t x = 0u;
        if (off[h] >= 0 && wi < tw) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (tb + 4 * wi + j < db) x |= (uint32_t)__ldg(codes + off[h] + 4 * wi + j) << (8 * j);
        }
        w[h][t] = x;
      }
    }
#pragma unroll
    for (int h = 0; h < kResRowsPerWarp; ++h) {
      if (off[h] < 0) continue;             // a pad slot (warp-uniform)
#pragma unroll
      for (int t = 0; t < kWords; ++t) {
        const int wi = lane + 32 * t;
        if (wi >= tw) continue;             // past a short last tile
#pragma unroll
        for (int j = 0; j < cpw; ++j)
          if (wi * cpw + j < nk)
            part[h] += T[RC::code(w[h][t], j) * kResTileStride + res_col(wi * cpw + j)];
      }
    }
#pragma unroll
    for (int h = 0; h < kResRowsPerWarp; ++h) {
      const float s = warp_sum(part[h]);
      if (lane == 0 && off[h] >= 0) acc[g + warp + kResWarps * h - r0] += s;
    }
  }
}

// Whether res_score_chunk may load codes (cap, D * bits / 8) a whole
// 4-byte word at a time: every row whole words, the codes aligned.
inline bool res_whole_words(const void* codes, int D, int bits) {
  return D * bits / 8 % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0;
}

template <int BITS, bool WHOLE>
__device__ __forceinline__ void res_score_chunk(
    const uint8_t* __restrict__ codes, const int* __restrict__ ids, int r0, int r1,
    const float* __restrict__ centroid, const float* __restrict__ values, const float* q,
    int D, float* sm) {
  using RC = ResCodes<BITS>;
  constexpr int L = RC::kLevels;
  constexpr int cpw = 32 / BITS;                         // codes a word
  constexpr int kWords = kResTileDims / cpw / 32;        // words a lane a row a tile
  float* T = sm;
  float* acc = sm + L * kResTileStride;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wpr = D / cpw;                               // words a row (WHOLE)
  const uint32_t* words = reinterpret_cast<const uint32_t*>(codes);
  __syncthreads();                          // the caller has read the last chunk
  for (int i = tid; i < r1 - r0; i += kResThreads) acc[i] = 0.f;
  for (int k0 = 0; k0 < D; k0 += kResTileDims) {
    const int nk = min(kResTileDims, D - k0);
    __syncthreads();                        // the previous tile is read, acc is zeroed
    for (int kk = tid; kk < nk; kk += kResThreads) {
      const int k = k0 + kk;
      const float qk = q[k], ck = __ldg(centroid + k);
      const float4* v4 = reinterpret_cast<const float4*>(values + (size_t)k * L);
#pragma unroll
      for (int l4 = 0; l4 < L / 4; ++l4) {
        const float4 v = __ldg(v4 + l4);
        T[(4 * l4 + 0) * kResTileStride + res_col(kk)] = qk * res_decode(ck, v.x);
        T[(4 * l4 + 1) * kResTileStride + res_col(kk)] = qk * res_decode(ck, v.y);
        T[(4 * l4 + 2) * kResTileStride + res_col(kk)] = qk * res_decode(ck, v.z);
        T[(4 * l4 + 3) * kResTileStride + res_col(kk)] = qk * res_decode(ck, v.w);
      }
    }
    __syncthreads();
    if constexpr (!WHOLE) {
      res_tile_rows_bytes<BITS>(codes, ids, r0, r1, k0, nk, D * BITS / 8, T, acc);
      continue;
    }
    const int tw = nk / cpw;                // words of the tile a row
    for (int g = r0; g < r1; g += kResGroup) {
      int off[kResRowsPerWarp];
      float part[kResRowsPerWarp];
      uint32_t w[kResRowsPerWarp][kWords];
#pragma unroll
      for (int h = 0; h < kResRowsPerWarp; ++h) {
        const int r = g + warp + kResWarps * h;
        off[h] = (r < r1 && ids[r] >= 0) ? r * wpr + k0 / cpw : -1;
        part[h] = 0.f;
#pragma unroll
        for (int t = 0; t < kWords; ++t) {
          const int wi = lane + 32 * t;
          w[h][t] = off[h] >= 0 && wi < tw ? __ldg(words + off[h] + wi) : 0u;
        }
      }
#pragma unroll
      for (int h = 0; h < kResRowsPerWarp; ++h) {
        if (off[h] < 0) continue;           // a pad slot (warp-uniform)
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
        if (lane == 0 && off[h] >= 0) acc[g + warp + kResWarps * h - r0] += s;
      }
    }
  }
  __syncthreads();
}
