// The exact top-k' of each query's candidates in device memory, for any k'.
// It finishes the dense scan (query_fused.cu: mips_topk; its bound too) and
// the one-launch IVF kernels (each query's probed strip).
//
// The key is score descending, then position ascending (jax.lax.top_k's
// order: the lower index first on a tie), packed into 64 bits: an
// order-preserving image of the score (-0 taken as +0, as the float
// comparison takes them) above the complement of the position.  Positions are unique, so keys are, and the k'-th largest key
// splits the candidates into exactly k' in and the rest out.
//
// One block a query.  A radix select finds the k'-th key a byte at a time
// (eight passes over the candidates, each a 256-bin histogram in shared
// memory of the keys that match the bytes chosen so far; it stops early
// once a bin holds exactly the entries still needed).  The keys at or
// above it are compacted into the query's k' slots of scratch, which are
// sorted kSelChunk at a time in shared memory (bitonic, descending); an
// entry's rank is its place in its chunk plus, in every other chunk, the
// number of keys above it (a binary search).  The result is written at its
// rank: the score decoded bit for bit, the position or the id it maps to,
// and (-inf, -1) past the candidates.  Entries scored -inf are pads (an
// IVF list's -1 slots) and are skipped.
//
// Work: 8 reads of the candidates (fewer on an early stop) and a sort of
// k' keys in chunks; one k'-th score with ``bound`` (4 passes, no stop:
// the exact bits of the k'-th score).
#pragma once

#include "common.cuh"

constexpr int kSelThreads = 512;
constexpr int kSelChunk = 8192;                 // keys sorted in shared memory at a time

typedef unsigned long long sel_key_t;

__device__ __forceinline__ sel_key_t sel_key(float s, int pos) {
  if (s == 0.f) s = 0.f;                        // -0 ties +0, as in a float compare
  uint32_t u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((sel_key_t)u << 32) | (sel_key_t)(0xFFFFFFFFu - (uint32_t)pos);
}

__device__ __forceinline__ float sel_score(sel_key_t k) {
  uint32_t u = (uint32_t)(k >> 32);
  u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int sel_pos(sel_key_t k) {
  return (int)(0xFFFFFFFFu - (uint32_t)k);
}

struct SelArgs {
  const float* s;        // (B, ld) candidate scores
  const int* p;          // (B, ld) positions, or null: the column is the position
  long long ld;
  const int* cnt;        // (B,) candidates a query, or null: n each
  int n;
  int cap;               // with cnt: more than cap candidates sets *overflow
  int kp;
  sel_key_t* scratch;    // (B, kp)
  float* out_s;          // (B, kp)
  int* out_i;            // (B, kp)
  float* bound;          // (B,) or null: write only the kp-th score (-inf if fewer)
  int* overflow;
  const int* probe;      // with ids: out_i = ids[probe[b][pos / lcap]][pos % lcap]
  const int* ids;
  int P, lcap;
};

__global__ void __launch_bounds__(kSelThreads) topk_select_kernel(const SelArgs a) {
  extern __shared__ __align__(16) sel_key_t keys[];   // kSelChunk
  __shared__ int hist[256];
  __shared__ sel_key_t s_prefix;
  __shared__ int s_need, s_done, s_count;
  const int b = blockIdx.x, tid = threadIdx.x;
  int n = a.n;
  if (a.cnt != nullptr) {
    n = a.cnt[b];
    if (n > a.cap) {                                 // block-uniform: the caller rescans
      if (tid == 0) *a.overflow = 1;
      return;
    }
  }
  const float* srow = a.s + (size_t)b * a.ld;
  const int* prow = a.p != nullptr ? a.p + (size_t)b * a.ld : nullptr;
  if (tid == 0) {
    s_prefix = 0;
    s_need = a.kp;
    s_done = 0;
  }
  const int passes = a.bound != nullptr ? 4 : 8;
  for (int pass = 0; pass < passes; ++pass) {
    for (int i = tid; i < 256; i += kSelThreads) hist[i] = 0;
    __syncthreads();
    if (s_done) break;                                // block-uniform
    const int shift = 56 - 8 * pass;
    const sel_key_t prefix = s_prefix;
    for (int i = tid; i < n; i += kSelThreads) {
      const float s = srow[i];
      if (!(s > -INFINITY)) continue;                 // a pad (or NaN)
      const sel_key_t k = sel_key(s, prow != nullptr ? prow[i] : i);
      if (pass > 0 && (k >> (shift + 8)) != (prefix >> (shift + 8))) continue;
      atomicAdd(&hist[(int)((k >> shift) & 255)], 1);
    }
    __syncthreads();
    if (tid == 0) {
      int need = s_need;
      if (pass == 0) {
        int tot = 0;
        for (int d = 0; d < 256; ++d) tot += hist[d];
        // every candidate is in (the bound needs the kp-th, so at least kp)
        if (a.bound != nullptr ? tot < need : tot <= need) s_done = 2;
      }
      if (!s_done) {
        int cum = 0, d = 255;
        for (; d > 0; --d) {
          if (cum + hist[d] >= need) break;
          cum += hist[d];
        }
        s_prefix = prefix | ((sel_key_t)d << shift);
        s_need = need - cum;
        if (a.bound == nullptr && hist[d] == need - cum) s_done = 1;  // the whole bin is in
      }
    }
    __syncthreads();
  }
  if (a.bound != nullptr) {
    if (tid == 0) a.bound[b] = s_done == 2 ? -INFINITY : sel_score(s_prefix);
    return;
  }
  const sel_key_t thr = s_done == 2 ? 0ull : s_prefix;
  if (tid == 0) s_count = 0;
  __syncthreads();
  sel_key_t* scr = a.scratch + (size_t)b * a.kp;
  for (int i = tid; i < n; i += kSelThreads) {
    const float s = srow[i];
    if (!(s > -INFINITY)) continue;
    const sel_key_t k = sel_key(s, prow != nullptr ? prow[i] : i);
    if (k >= thr) {
      const int at = atomicAdd(&s_count, 1);
      if (at < a.kp) scr[at] = k;
    }
  }
  __syncthreads();
  const int c = min(s_count, a.kp);
  const int nch = (c + kSelChunk - 1) / kSelChunk;
  for (int ch = 0; ch < nch; ++ch) {                  // sort each chunk, descending
    const int c0 = ch * kSelChunk, len = min(kSelChunk, c - c0);
    int n2 = 1;
    while (n2 < len) n2 <<= 1;
    for (int i = tid; i < n2; i += kSelThreads) keys[i] = i < len ? scr[c0 + i] : 0ull;
    __syncthreads();
    for (int k = 2; k <= n2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < n2; i += kSelThreads) {
          const int l = i ^ j;
          if (l <= i) continue;
          const sel_key_t x = keys[i], y = keys[l];
          if ((i & k) == 0 ? x < y : x > y) {
            keys[i] = y;
            keys[l] = x;
          }
        }
        __syncthreads();
      }
    }
    for (int i = tid; i < len; i += kSelThreads) scr[c0 + i] = keys[i];
    __syncthreads();
  }
  float* os = a.out_s + (size_t)b * a.kp;
  int* oi = a.out_i + (size_t)b * a.kp;
  for (int e = tid; e < c; e += kSelThreads) {
    const sel_key_t k = scr[e];
    const int ce = e / kSelChunk;
    int rank = e - ce * kSelChunk;
    for (int c2 = 0; c2 < nch; ++c2) {
      if (c2 == ce) continue;
      const sel_key_t* arr = scr + (size_t)c2 * kSelChunk;
      int lo = 0, hi = min(kSelChunk, c - c2 * kSelChunk);   // keys above k: a prefix
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (arr[mid] > k) lo = mid + 1;
        else hi = mid;
      }
      rank += lo;
    }
    const int pos = sel_pos(k);
    os[rank] = sel_score(k);
    oi[rank] = a.ids != nullptr
                   ? a.ids[(size_t)a.probe[(size_t)b * a.P + pos / a.lcap] * a.lcap + pos % a.lcap]
                   : pos;
  }
  for (int e = c + tid; e < a.kp; e += kSelThreads) {
    os[e] = -INFINITY;
    oi[e] = -1;
  }
}

static int launch_topk_select(const SelArgs& a, int B, cudaStream_t stream) {
  if (B <= 0) return (int)cudaSuccess;
  const size_t smem = kSelChunk * sizeof(sel_key_t);
  cudaError_t err = allow_smem(topk_select_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  topk_select_kernel<<<B, kSelThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
