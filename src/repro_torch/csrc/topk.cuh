// A top-k list kept in shared memory and folded into a few entries at a
// time, for the one-launch query kernels (query_fused.cu) and the dense
// scan's merge.
//
// Every comparison uses one key: score descending, then position
// ascending, the order of jax.lax.top_k (the lower index first on a tie)
// and of the port's stable_topk.  Positions are unique, so the key is a
// total order and the result does not depend on the order the entries
// arrive in: a fold needs no sort that is stable.  The list is always kp
// entries long; empty entries are (-inf, kNoPos) and come last.
//
// A fold takes the entries that beat the list's last entry, sorts them by
// the key (bitonic, in shared memory) and merges them in place: an entry's
// new place is its index plus the number of entries of the other side that
// beat it (a binary search), and the list's own entries only move up, so
// they are moved from the top down and each chunk of them is read before
// it is written.
#pragma once

#include <limits.h>

#include "common.cuh"

constexpr int kNoPos = INT_MAX;  // the position of an empty entry

// The threads that fold one list together: the whole block, or one warp.
struct BlockGroup {
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ void sync() const { __syncthreads(); }
};

struct WarpGroup {
  __device__ int rank() const { return threadIdx.x & 31; }
  __device__ int size() const { return 32; }
  __device__ void sync() const { __syncwarp(); }
};

__device__ __forceinline__ bool better(float sa, int pa, float sb, int pb) {
  return sa > sb || (sa == sb && pa < pb);
}

// How many of the n sorted entries (s, p) beat (x, xp).
__device__ __forceinline__ int count_better(const float* s, const int* p, int n,
                                            float x, int xp) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(s[mid], p[mid], x, xp)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <class G>
__device__ void topk_clear(float* ts, int* tp, int kp, G g) {
  for (int i = g.rank(); i < kp; i += g.size()) {
    ts[i] = -INFINITY;
    tp[i] = kNoPos;
  }
  g.sync();
}

// Sort n entries by the key, best first.  The arrays hold the next power of
// two >= n entries; the tail is filled with empty entries.
template <class G>
__device__ void bitonic_sort(float* s, int* p, int n, G g) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int i = n + g.rank(); i < n2; i += g.size()) {
    s[i] = -INFINITY;
    p[i] = kNoPos;
  }
  g.sync();
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = g.rank(); i < n2; i += g.size()) {
        const int l = i ^ j;
        if (l <= i) continue;
        const bool up = (i & k) == 0;
        if (up ? better(s[l], p[l], s[i], p[i]) : better(s[i], p[i], s[l], p[l])) {
          const float sv = s[i];
          s[i] = s[l];
          s[l] = sv;
          const int tq = p[i];
          p[i] = p[l];
          p[l] = tq;
        }
      }
      g.sync();
    }
  }
}

// Merge n sorted entries (es, ep) into the sorted list (ts, tp) of kp
// entries, in place, keeping the kp best.  n <= kMaxPer * g.size(): each
// thread keeps the new places of its entries in registers.
template <int kMaxPer, class G>
__device__ void topk_merge(float* ts, int* tp, int kp, const float* es,
                           const int* ep, int n, G g) {
  int edst[kMaxPer];
#pragma unroll
  for (int t = 0; t < kMaxPer; ++t) {
    const int j = g.rank() + t * g.size();
    edst[t] = j < n ? j + count_better(ts, tp, kp, es[j], ep[j]) : kp;
  }
  g.sync();
  for (int base = (kp - 1) / g.size() * g.size(); base >= 0; base -= g.size()) {
    const int i = base + g.rank();
    float s = 0.f;
    int p = 0, dst = kp;
    if (i < kp) {
      s = ts[i];
      p = tp[i];
      dst = i + count_better(es, ep, n, s, p);
    }
    g.sync();
    if (dst < kp) {
      ts[dst] = s;
      tp[dst] = p;
    }
    g.sync();
  }
#pragma unroll
  for (int t = 0; t < kMaxPer; ++t) {
    if (edst[t] < kp) {
      const int j = g.rank() + t * g.size();
      ts[edst[t]] = es[j];
      tp[edst[t]] = ep[j];
    }
  }
  g.sync();
}
