// The token MaxSim body on Hopper's tensor cores, shared by token_maxsim.cu
// (the max over each doc's tokens), rerank_gather.cu (then the masked sum
// over each query's tokens), rerank_paged.cu (the same over fp32 token
// pages, copied by the producer warps) and rerank_paged_res.cu (over
// compressed token pages, decoded by the producer warps); each file's
// header says what it replaces and what bounds it.
//
// An item is a doc (token MaxSim) or a candidate (the rerank): Tr token
// rows, contiguous in an (items, Tr, D) store, fp32 or int8 codes with a
// scale a row, and a validity mask (items, Tr).  For a B row i (an OLS
// token, a query token) the kernel computes max over item l's valid rows t
// of <row t, b_i> (x its scale), NEG where l has none: the product of
// tc_common.cuh (3xTF32 for fp32 rows, 2xTF32 for int8 codes, the tensor
// cores' sums restarted every 64 columns into a rounded fp32 total), so the
// dots are those of an fp32 product up to fp32 rounding; the rerank then
// sums the maxima over the query's valid tokens.
//
// Work: a block owns one group of B rows, whose split image (tc_image) is
// wgmma's N operand: a tile of N = 128 OLS tokens, or one query's Tq
// tokens in NT tiles of N = 32, 64 or 128; and a run of rounds.  In round r
// each of the 8 consumer warps takes one item, r x 8 + warp, 16 rows at a
// time (a slice; S = ceil(Tr / 16) slices an item): wgmma gives a warp 16
// of its warpgroup's 64 M rows, and since A comes from registers, each warp
// can feed rows of its own item.  B: the producer warpgroup's first thread
// copies the group's NT x KC chunks once when they fit the 128 KB ring
// (resident: d <= 128 at N = 128, d <= 512 at N = 32), else streams
// them through it step by step.  A comes one of two ways, chosen at launch
// from the widths:
//  - the cp.async path (token MaxSim; a rerank whose rows are not whole
//    16-byte units or whose B streams): each consumer thread fetches its
//    two rows of the slice (16 s + g and + 8) through its own ring of
//    shared memory, a chunk at a time, kTcWStages - 1 chunks ahead
//    (tc_fetch_rows; a masked row is not read), the rows' mask bytes and
//    the next item's candidate loaded a slice ahead of the fetches so that
//    none waits on them;
//  - the bulk path (the rerank otherwise): the producer warps read the
//    slices' mask bytes and scales and bring each slice's rows, from its
//    first valid one to its last, with one bulk copy into a ring of slots a
//    consumer warp, a slice ahead: the row addresses, masks and scales are
//    off the consumer warps, whose instructions bound the rerank;
//  - the paged residual rerank (kMxRerankRes): an item is a candidate's
//    pages, a page one 16-row slice.  Each producer warp serves two
//    consumer warps: it copies a page's packed codes and centroid ids into
//    a staging ring (cp.async, kMxPgStages pages ahead) and decodes the
//    residual part values[k][code] of its 16 rows into the consumer's
//    slot, from a values table in shared memory; the centroid part enters
//    the epilogue from a (ncent x Tq) table of q_t . centroid (built by a
//    launch before), so no centroid row is read.  Rows at or past the
//    candidate's n_tokens are masked by position; a round walks as many
//    slices as the most pages among its 8 candidates (at least one);
//  - the paged fp32 rerank (kMxRerankPaged): the same walk, each producer
//    warp bringing a page's valid rows straight into the consumer's slot
//    with one bulk copy (no staging, no decode), kMxPgSlots slots a
//    consumer warp.
// The consumers split the rows in registers (int8 widened exactly) and
// issue the products against the B chunk in shared memory, the producer
// warpgroup's registers given to them (setmaxnreg).  A commit group holds
// the k-steps of a chunk's quarter (N = 128), half (64) or whole (32), the
// A registers double-buffered between groups.
//
// Epilogue of a slice (a thread's totals: rows g, g + 8 of its warp's 16,
// columns 8j + 2t + c): masked rows to NEG (after the scale), the max of
// the two rows, then the max over the warp's 8 row lanes as a
// reduce-scatter (three shuffle rounds, 16, 8 and 4 lanes apart, each
// halving the values a lane keeps), which leaves each lane N / 32 columns'
// maxima over the slice, folded into a running max over the item's slices
// in registers: no item straddles anything.  At the item's last slice,
// token MaxSim writes the round's 8 docs for its N tokens through shared
// memory (8 consecutive floats a row of out); the rerank sums its lanes'
// valid query columns (a warp sum) into the candidate's score, across its
// NT tiles through shared memory.  Every item's rows sit in the same
// places of the same sums whichever warp takes it, so duplicated
// candidates score alike to the bit.
#pragma once

#include <type_traits>

#include "tc_common.cuh"

constexpr int kMxWarps = kTcConsumers / 32;   // items in flight in a block
constexpr int kMxSlice = 16;                  // rows of an item a warp takes at a time
constexpr int kMxRingFloats = 32 * 1024;      // the B ring: 128 KB
// the consumers' cp.async rings of A values: tc_scan.cuh's, 64 KB
constexpr int kMxAFloats = kTcWStages * kTcConsumers * kTcWSlot;

template <int N>
struct MxTile {
  static_assert(N == 32 || N == 64 || N == 128, "the MaxSim body's wgmma widths");
  static constexpr int kPiece = N * kTcK;               // floats of one split piece of a chunk
  static constexpr int kChunk = 2 * kPiece;
  static constexpr int kLbo = N / 8 * 128;              // bytes between a k-step's column halves
  static constexpr int kStages = kMxRingFloats / kChunk;
  static constexpr int kKsg = 128 / N;                  // k-steps a commit group
  static constexpr int kGroups = 4 / kKsg;              // commit groups a chunk
  static constexpr int kV = N / 4;                      // a thread's columns
  static constexpr int kR = N / 32;                     // ... after the max over its row lanes
};

enum { kMxTokenMaxSim = 0, kMxRerank = 1, kMxRerankRes = 2, kMxRerankPaged = 3 };
constexpr int kMxPgStages = 3;              // (paged residual) pages a producer warp stages
constexpr int kMxPgSlots = 3;               // (paged fp32) the most slots a consumer warp


struct MxArgs {
  const float* img;       // tc_image of the groups' B rows, N rows a tile, NT tiles a group
  const void* tok;        // (items, Tr, D) fp32 or int8
  const uint8_t* mask;    // (items, Tr)
  const float* scales;    // (items, Tr) (int8 rows)
  float* out;
  int D, KC, Tr, S, NT, resident, vec, ebuf;
  int R, pitch, abytes;   // (bulk) slices a consumer warp, their row pitch; the A area's bytes
  int groups, runs, rounds, items;   // image groups; blocks a group; rounds of 8 items; items
  int n;                  // token MaxSim: B rows (out (n, items), group gi: rows gi N ..)
  const int* cand;        // rerank: (groups, kp) candidates, clamped to the items
  const uint8_t* q_mask;  // rerank: (groups, Tq)
  int Tq, kp;
};

// The paged reranks' arguments (their kernels alone take them: a larger
// argument block changes how the other clients' kernels compile); the fp32
// pages are a.tok, and take gpt, gnt and pmax.
struct MxResArgs : MxArgs {
  const int* gpt;         // (groups, kp, pmax) each candidate's page ids, clamped, -1 past them
  const int* gnt;         // (groups, kp) each candidate's token count (0: a pad)
  const int* cent_pages;  // (n_pages, 16) centroid ids
  const uint8_t* code_pages;  // (n_pages, 16, db) packed codes
  const float* qc;        // (groups, ncent, qcs): q_t . centroid in column t
  const float* values;    // (D, 2^bits) the codec's residual values
  int pmax, ncent, qcs, db, vstride, stage_bytes;
};

// v: a thread's V column values (its two rows' max) -> w: the max over the
// warp's 8 row lanes of columns (V / 8) g .. + V / 8 of v.
template <int V>
__device__ __forceinline__ void mx_max_over_rows(const float (&v)[V], int lane,
                                                 float (&w)[V / 8]) {
  float a1[V / 2], a2[V / 4];
  const bool u1 = lane & 16, u2 = lane & 8, u3 = lane & 4;
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float send = u1 ? v[i] : v[i + V / 2], keep = u1 ? v[i + V / 2] : v[i];
    a1[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, 16));
  }
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const float send = u2 ? a1[i] : a1[i + V / 4], keep = u2 ? a1[i + V / 4] : a1[i];
    a2[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, 8));
  }
#pragma unroll
  for (int i = 0; i < V / 8; ++i) {
    const float send = u3 ? a2[i] : a2[i + V / 8], keep = u3 ? a2[i + V / 8] : a2[i];
    w[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, 4));
  }
}

// A consumer thread's A values of chunk kc from a slice in shared memory
// (the bulk path): rows g and g + 8 of the slot, `pitch` bytes apart from
// row0p, columns col0 .. col0 + 7; 0 past D where the last chunk is partial.
template <typename T>
__device__ __forceinline__ void mx_read_slot(const uint8_t* row0p, int pitch, int col0, int D,
                                             bool part, float (&v)[2][8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint8_t* p = row0p + (size_t)h * 8 * pitch + (size_t)col0 * sizeof(T);
    if constexpr (sizeof(T) == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p);
      const float4 y = *reinterpret_cast<const float4*>(p + 16);
      v[h][0] = x.x; v[h][1] = x.y; v[h][2] = x.z; v[h][3] = x.w;
      v[h][4] = y.x; v[h][5] = y.y; v[h][6] = y.z; v[h][7] = y.w;
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      const uint32_t w[2] = {x.x ^ 0x80808080u, x.y ^ 0x80808080u};
#pragma unroll
      for (int j = 0; j < 8; ++j) v[h][j] = s8_to_float(w[j / 4], j % 4);
    }
    if (part) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (col0 + j >= D) v[h][j] = 0.f;
    }
  }
}

// (paged residual) The shared memory after the slots' valid bits: each slot's round
// length, the q . centroid table, the values table and the producer warps'
// staging rings (msc holds the slots' centroid ids).  The staging offset is
// taken from the shared array, not by an integer cast, so that the compiler
// keeps the producers' accesses in the shared window.
struct MxResSmem {
  int* mS;
  float* qct;
  float* vs;
  uint8_t* stg;
};

template <int BITS>
__device__ __forceinline__ MxResSmem mx_res_smem(const MxResArgs& a, uint32_t* mbits,
                                                 float* base) {
  MxResSmem r;
  r.mS = reinterpret_cast<int*>(mbits + kMxWarps * a.R);
  r.qct = reinterpret_cast<float*>(r.mS + kMxWarps * a.R);
  r.vs = r.qct + (size_t)a.ncent * a.qcs;
  uint8_t* const b8 = reinterpret_cast<uint8_t*>(base);
  r.stg = b8 + ((reinterpret_cast<uint8_t*>(r.vs + (size_t)(1 << BITS) * a.vstride) - b8 + 15) &
                ~(ptrdiff_t)15);
  return r;
}

// The paged residual rerank's producer warp pw (0 .. 3), for consumer warps
// 2 pw and 2 pw + 1 and their slices in the consumers' order (each round:
// its S slices, the two warps' in turn).  A lookahead cursor reads each
// round's token counts and page ids (the launch before gathered them a
// candidate a row) a round ahead, and starts the copies of each page (its
// packed codes, then its 16 centroid ids) into the warp's staging ring
// (cp.async) kMxPgStages - 1 pages ahead, with a header: the slot, its
// use, the round's S and the rows in the page (0: no page).  The decoder
// waits for a page's copies and its slot, writes values[k][code] of its 16
// rows there (lane l takes dims 4 l .. 4 l + 3, from vs:
// each lane on its own bank; 8 rows' codes, then their lookups, in flight
// together), the centroid ids (clamped) into msc, the valid rows' bits and
// S, and arrives on the slot's barrier.
template <int BITS>
__device__ __forceinline__ void mx_res_producer(const MxResArgs& a, int gi, int r0, int r1, int pw,
                                                int lane, uint8_t* area, float* msc,
                                                uint32_t* mbits, int* mS, const float* vs,
                                                uint8_t* stg, uint64_t* sfull,
                                                uint64_t* sempty) {
  constexpr int kLv = 1 << BITS, kPer = 8 / BITS;
  constexpr unsigned kAll = 0xffffffffu;
  uint8_t* ring = stg + (size_t)pw * kMxPgStages * a.stage_bytes;
  // the lookahead cursor: tile, round, slice, which warp, the warps' slices
  // so far; the round's S, the two candidates' token counts and page ids
  // (lane j: page j), and the next round's, in flight
  int L_nt = 0, L_r = r0, L_s = 0, L_h = 0, L_us = 0, L_S = 1;
  int L_tok[2] = {0, 0}, L_pt[2] = {-1, -1};
  int nx_tok = 0, nx_pt[2] = {-1, -1};
  bool L_end = false;
  auto round_load = [&](int r) {
    const int i = r * kMxWarps + lane;
    nx_tok = lane < kMxWarps && i < a.kp ? __ldg(a.gnt + (size_t)gi * a.kp + i) : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ih = r * kMxWarps + 2 * pw + h;
      nx_pt[h] = ih < a.kp && lane < a.pmax
                     ? __ldg(a.gpt + ((size_t)gi * a.kp + ih) * a.pmax + lane) : -1;
    }
  };
  auto enter = [&](int r) {                     // round r's info in; the next one's loads out
    int npg = min((nx_tok + kMxSlice - 1) / kMxSlice, a.pmax);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) npg = max(npg, __shfl_xor_sync(kAll, npg, o));
    L_S = max(npg, 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      L_tok[h] = __shfl_sync(kAll, nx_tok, 2 * pw + h);
      L_pt[h] = nx_pt[h];
    }
    round_load(r + 1 == r1 ? r0 : r + 1);
  };
  auto issue = [&](int buf) {
    uint8_t* sb = ring + (size_t)buf * a.stage_bytes;
    int* hdr = reinterpret_cast<int*>(sb + a.stage_bytes - 16);
    if (L_end) {
      if (lane == 0) hdr[3] = -2;
      cp_async_commit();
      return;
    }
    const int nv = min(kMxSlice, (L_h ? L_tok[1] : L_tok[0]) - kMxSlice * L_s);
    if (nv > 0) {                                // warp-uniform
      const int pid = L_s < 32 ? __shfl_sync(kAll, L_h ? L_pt[1] : L_pt[0], L_s)
                               : __ldg(a.gpt + ((size_t)gi * a.kp + (size_t)L_r * kMxWarps +
                                                2 * pw + L_h) * a.pmax + L_s);
      const uint8_t* codes = a.code_pages + (size_t)pid * kMxSlice * a.db;
      const int* cents = a.cent_pages + (size_t)pid * kMxSlice;
      for (int c = lane; c < a.db + 4; c += 32)  // 16 x db bytes of codes, 64 of ids
        cp_async(sb + 16 * c, c < a.db ? static_cast<const void*>(codes + 16 * c)
                                       : static_cast<const void*>(cents + 4 * (c - a.db)),
                 16, true);
    }
    if (lane == 0) {
      hdr[0] = (2 * pw + L_h) * a.R + L_us % a.R;
      hdr[1] = L_us / a.R;
      hdr[2] = L_S;
      hdr[3] = max(nv, 0);
    }
    cp_async_commit();
    if (++L_h == 2) {
      L_h = 0;
      ++L_us;
      if (++L_s == L_S) {
        L_s = 0;
        if (++L_r == r1) {
          L_r = r0;
          L_end = ++L_nt == a.NT;
        }
        if (!L_end) enter(L_r);
      }
    }
  };
  round_load(r0);
  enter(r0);
  const int pf = a.pitch / 4;                   // floats between a slot's rows
  for (int i = 0; i < kMxPgStages - 1; ++i) issue(i);
  for (int n = 0;; ++n) {
    issue((n + kMxPgStages - 1) % kMxPgStages);  // the page decoded last round is free
    cp_async_wait<kMxPgStages - 1>();
    __syncwarp();
    const uint8_t* sb = ring + (size_t)(n % kMxPgStages) * a.stage_bytes;
    const int* hdr = reinterpret_cast<const int*>(sb + a.stage_bytes - 16);
    const int sw = hdr[0], use = hdr[1], S = hdr[2], nv = hdr[3];
    if (nv == -2) break;
    if (use > 0) mbar_wait(&sempty[sw], (use - 1) & 1);
    float* slot = reinterpret_cast<float*>(area + (size_t)sw * kMxSlice * a.pitch);
    if (nv > 0 && a.D % 4 == 0) {                 // (no page: the slot's rows are masked)
      // 8 rows at a time: their codes, then their 32 lookups, in flight together
      for (int k4 = lane; k4 < a.D / 4; k4 += 32) {
        const int k = 4 * k4;
        const float* v0 = vs + k + (k >> 5);
#pragma unroll
        for (int r0 = 0; r0 < kMxSlice; r0 += 8) {
          uint32_t c4[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const uint8_t* cr = sb + (r0 + i) * a.db;
            c4[i] = BITS == 4 ? *reinterpret_cast<const uint16_t*>(cr + 2 * k4) : cr[k4];
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float4 o;
            o.x = v0[((c4[i] >> (0 * BITS)) & (kLv - 1)) * a.vstride];
            o.y = v0[((c4[i] >> (1 * BITS)) & (kLv - 1)) * a.vstride + 1];
            o.z = v0[((c4[i] >> (2 * BITS)) & (kLv - 1)) * a.vstride + 2];
            o.w = v0[((c4[i] >> (3 * BITS)) & (kLv - 1)) * a.vstride + 3];
            *reinterpret_cast<float4*>(slot + (r0 + i) * pf + k) = o;
          }
        }
      }
    } else if (nv > 0) {
      for (int row = 0; row < kMxSlice; ++row) {
        const uint8_t* cr = sb + row * a.db;
        for (int k = lane; k < a.D; k += 32) {
          const int code = (cr[k / kPer] >> (BITS * (k % kPer))) & (kLv - 1);
          slot[row * pf + k] = vs[code * a.vstride + k + (k >> 5)];
        }
      }
    }
    if (lane < kMxSlice) {                        // (no page: 0, never read)
      const int cid = nv > 0 ? reinterpret_cast<const int*>(sb + kMxSlice * a.db)[lane] : 0;
      msc[sw * kMxSlice + lane] = __int_as_float(min(max(cid, 0), a.ncent - 1));
    }
    if (lane == 0) {
      mbits[sw] = nv >= kMxSlice ? 0xffffu : (1u << nv) - 1u;
      mS[sw] = S;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sfull[sw]);
  }
}

// The paged fp32 rerank's producer warp pw (0 .. 3), for consumer warps
// 2 pw and 2 pw + 1 and their slices in the consumers' order (each round:
// its S slices, the two warps' in turn).  Each round's token counts and
// page ids (the launch before gathered them a candidate a row) are read a
// round ahead.  For each slice the warp waits for the consumer's slot,
// writes its valid rows' bits and the round's S, and brings the page's
// valid rows into the slot with one bulk copy on the slot's barrier.  A
// slice with no page (a candidate with fewer pages than the round's S) is
// only marked: no valid row.
__device__ __forceinline__ void mx_pg_producer(const MxResArgs& a, int gi, int r0, int r1, int pw,
                                               int lane, uint8_t* area, uint32_t* mbits, int* mS,
                                               uint64_t* sfull, uint64_t* sempty) {
  constexpr unsigned kAll = 0xffffffffu;
  const uint8_t* tok = static_cast<const uint8_t*>(a.tok);
  const int rowbytes = a.pitch;                  // a slot holds the page as it lies
  int nx_tok = 0, nx_pt[2] = {-1, -1};
  auto round_load = [&](int r) {
    const int i = r * kMxWarps + lane;
    nx_tok = lane < kMxWarps && i < a.kp ? __ldg(a.gnt + (size_t)gi * a.kp + i) : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ih = r * kMxWarps + 2 * pw + h;
      nx_pt[h] = ih < a.kp && lane < a.pmax
                     ? __ldg(a.gpt + ((size_t)gi * a.kp + ih) * a.pmax + lane) : -1;
    }
  };
  round_load(r0);
  int us = 0;
  for (int nt = 0; nt < a.NT; ++nt) {
    for (int r = r0; r < r1; ++r) {
      int npg = min((nx_tok + kMxSlice - 1) / kMxSlice, a.pmax);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) npg = max(npg, __shfl_xor_sync(kAll, npg, o));
      const int S = max(npg, 1);
      int tok2[2], pt[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tok2[h] = __shfl_sync(kAll, nx_tok, 2 * pw + h);
        pt[h] = nx_pt[h];
      }
      round_load(r + 1 == r1 ? r0 : r + 1);     // the next round's, in flight
      for (int s = 0; s < S; ++s, ++us) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int sw = (2 * pw + h) * a.R + us % a.R;
          const int nv = min(kMxSlice, tok2[h] - kMxSlice * s);
          int pid = s < 32 ? __shfl_sync(kAll, pt[h], s) : 0;
          if (s >= 32 && nv > 0)
            pid = __ldg(a.gpt + ((size_t)gi * a.kp + (size_t)r * kMxWarps + 2 * pw + h) * a.pmax +
                        s);
          if (us >= a.R) mbar_wait(&sempty[sw], ((us / a.R) - 1) & 1);
          if (lane == 0) {
            mbits[sw] = nv >= kMxSlice ? 0xffffu : (nv > 0 ? (1u << nv) - 1u : 0u);
            mS[sw] = S;
          }
          __syncwarp();
          if (lane == 0) {
            if (nv > 0) {
              mbar_expect_tx(&sfull[sw], (uint32_t)(nv * rowbytes));
              bulk_copy_g2s(area + (size_t)sw * kMxSlice * rowbytes,
                            tok + (size_t)pid * kMxSlice * rowbytes, (uint32_t)(nv * rowbytes),
                            &sfull[sw]);
            } else {
              mbar_arrive(&sfull[sw]);
            }
          }
        }
      }
    }
  }
}

template <typename T, int N, int KIND, bool BULK, int BITS = 0>
__global__ void __launch_bounds__(kTcThreads, 1)
maxsim_tc_kernel(const std::conditional_t<KIND >= kMxRerankRes, MxResArgs, MxArgs> a) {
  static_assert(!BULK || KIND != kMxTokenMaxSim, "the bulk path feeds the reranks");
  static_assert(KIND != kMxRerankRes || (BULK && sizeof(T) == 4 && (BITS == 2 || BITS == 4)),
                "the paged residual rerank decodes fp32 slots");
  static_assert(KIND != kMxRerankPaged || (BULK && sizeof(T) == 4 && BITS == 0),
                "the paged fp32 rerank copies fp32 pages");
  constexpr bool RES = KIND == kMxRerankRes;
  constexpr bool PG = KIND == kMxRerankPaged;
  constexpr bool WALK = RES || PG;                 // the producers walk candidates' pages
  using Tl = MxTile<N>;
  // producer and consumer registers: 128 x P + 256 x C <= 65,536
  constexpr int kProducerRegs = RES ? 88 : (BULK ? 56 : 40);
  extern __shared__ __align__(128) float mx_sm[];
  const int nst = a.resident ? a.NT * a.KC : Tl::kStages;
  float* stages = mx_sm;
  uint8_t* area = reinterpret_cast<uint8_t*>(stages + (size_t)nst * Tl::kChunk);
  // the A area: the consumers' cp.async rings, or (bulk) the slices a.R a
  // consumer warp, each 16 rows a.pitch bytes apart, their scales and
  // valid bits
  float* wring = reinterpret_cast<float*>(area);
  float* msc = reinterpret_cast<float*>(area + (size_t)kMxWarps * a.R * kMxSlice * a.pitch);
  uint32_t* mbits = reinterpret_cast<uint32_t*>(msc + (PG ? 0 : kMxWarps * a.R * kMxSlice));
  int* pg_S = reinterpret_cast<int*>(mbits + kMxWarps * a.R);   // (paged fp32) a slot's round S
  float* ebuf = reinterpret_cast<float*>(area + a.abytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(ebuf + a.ebuf);
  uint64_t* empty = full + nst;
  uint64_t* sfull = empty + nst;                   // (bulk) kMxWarps x a.R
  uint64_t* sempty = sfull + kMxWarps * a.R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // token MaxSim: the group (a tile of OLS tokens) varies fastest, so the
  // blocks in flight walk the same docs and read them from L2
  const int gi = KIND == kMxTokenMaxSim ? blockIdx.x % a.groups : blockIdx.x / a.runs;
  const int u = KIND == kMxTokenMaxSim ? blockIdx.x / a.groups : blockIdx.x % a.runs;
  const int r0 = (int)((long long)u * a.rounds / a.runs);
  const int r1 = (int)((long long)(u + 1) * a.rounds / a.runs);
  const int per_nt = (r1 - r0) * a.S * a.KC;
  const int steps = a.NT * per_nt;
  const float* img = a.img + (size_t)gi * a.NT * a.KC * Tl::kChunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kMxWarps);             // lane 0 of each consumer warp
    }
    if constexpr (BULK) {
      for (int s = 0; s < kMxWarps * a.R; ++s) {
        mbar_init(&sfull[s], 1);                   // the producer lane of the slice's row 0
        mbar_init(&sempty[s], 1);                  // lane 0 of the consumer warp
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (RES) {                             // the query's tables, by every thread
    const MxResSmem rs = mx_res_smem<BITS>(a, mbits, mx_sm);
    const float* qg = a.qc + (size_t)gi * a.ncent * a.qcs;
#pragma unroll 4
    for (int i = threadIdx.x; i < a.ncent * a.qcs; i += kTcThreads) rs.qct[i] = __ldg(qg + i);
#pragma unroll 4
    for (int i = threadIdx.x; i < (1 << BITS) * a.D; i += kTcThreads)
      rs.vs[(i / a.D) * a.vstride + (i % a.D) + (i % a.D) / 32] =
          __ldg(a.values + (size_t)(i % a.D) * (1 << BITS) + i / a.D);
  }
  __syncthreads();

  // the warp's item of round r (consumer warp w): its candidate as stored
  // (rerank), then the store row of its row 0, -1 past the items
  auto item_raw = [&](int r, int w) -> int {
    const int i = r * kMxWarps + w;
    if constexpr (KIND == kMxTokenMaxSim) {
      return i;
    } else if constexpr (WALK) {
      return 0;                                   // (the producers walk the pages)
    } else {
      return i < a.kp ? __ldg(a.cand + (size_t)gi * a.kp + i) : 0;
    }
  };
  auto item_row0 = [&](int r, int w, int raw) -> long long {
    const int i = r * kMxWarps + w;
    if constexpr (KIND == kMxTokenMaxSim) {
      return i < a.items ? (long long)i * a.Tr : -1;
    } else {
      if (i >= a.kp) return -1;
      const int c = raw < 0 ? 0 : (raw >= a.items ? a.items - 1 : raw);
      return (long long)c * a.Tr;
    }
  };

  if (warp >= kMxWarps) {                          // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == kTcConsumers) {             // B: one thread
      constexpr uint32_t bytes = Tl::kChunk * sizeof(float);
      if (a.resident) {
        for (int c = 0; c < nst; ++c) {
          mbar_expect_tx(&full[c], bytes);
          bulk_copy_g2s(stages + (size_t)c * Tl::kChunk, img + (size_t)c * Tl::kChunk, bytes,
                        &full[c]);
        }
      } else {
        for (int it = 0; it < steps; ++it) {
          const int s = it % nst;
          if (it >= nst) mbar_wait(&empty[s], ((it / nst) - 1) & 1);
          const int c = it / per_nt * a.KC + it % a.KC;   // chunk kc of tile nt
          mbar_expect_tx(&full[s], bytes);
          bulk_copy_g2s(stages + (size_t)s * Tl::kChunk, img + (size_t)c * Tl::kChunk, bytes,
                        &full[s]);
        }
      }
    }
    if constexpr (RES) {
      const MxResSmem rs = mx_res_smem<BITS>(a, mbits, mx_sm);
      mx_res_producer<BITS>(a, gi, r0, r1, warp - kMxWarps, lane, area, msc, mbits, rs.mS, rs.vs,
                            rs.stg, sfull, sempty);
    } else if constexpr (PG) {
      mx_pg_producer(a, gi, r0, r1, warp - kMxWarps, lane, area, mbits, pg_S, sfull, sempty);
    } else if constexpr (BULK) {
      // A (the bulk path; B is resident): lanes 16 h + i of producer warp p
      // read row i's mask byte and scale of consumer warp 2p + h's slices,
      // in the consumers' order, and lane 16 h sends the slice's rows from
      // its first valid one to its last in one bulk copy; the mask bytes
      // and scales of the slice after are in flight meanwhile, and the
      // candidate of the item after that.
      const int half = lane >> 4, i = lane & 15, cw = 2 * (warp - kMxWarps) + half;
      const uint8_t* tokb = static_cast<const uint8_t*>(a.tok);
      const int rowbytes = a.D * (int)sizeof(T);
      int lr = r0, ls = 0;
      long long lrow0 = item_row0(r0, cw, item_raw(r0, cw));
      int lnext = item_raw(r0 + 1 < r1 ? r0 + 1 : r0, cw);
      bool lin;
      uint8_t lm;
      float lsc;
      auto lload = [&]() {
        const int rr = ls * kMxSlice + i;
        lin = lrow0 >= 0 && rr < a.Tr;
        lm = lin ? a.mask[lrow0 + rr] : (uint8_t)0;
        lsc = 1.f;
        if constexpr (sizeof(T) == 1) {
          if (lin) lsc = __ldg(a.scales + lrow0 + rr);
        }
      };
      lload();
      const int total = a.NT * (r1 - r0) * a.S;
      for (int us = 0; us < total; ++us) {
        const long long row = lrow0 + ls * kMxSlice + i;
        const bool ok = lin && lm != 0;
        const float sc = lsc;
        if (++ls == a.S) {
          ls = 0;
          const int r = lr + 1 == r1 ? r0 : lr + 1;
          lrow0 = item_row0(r, cw, lnext);
          lr = r;
          lnext = item_raw(r + 1 < r1 ? r + 1 : r0, cw);
        }
        lload();
        const int sw = cw * a.R + us % a.R;
        if (us >= a.R) mbar_wait(&sempty[sw], ((us / a.R) - 1) & 1);
        const unsigned bits = (__ballot_sync(0xffffffffu, ok) >> (16 * half)) & 0xffffu;
        msc[sw * kMxSlice + i] = sc;
        if (i == 0) mbits[sw] = bits;
        __syncwarp();
        if (i == 0) {                              // rows lo .. hi in one copy
          if (bits) {
            const int lo = __ffs(bits) - 1, hi = 31 - __clz(bits);
            const uint32_t bytes = (uint32_t)((hi - lo + 1) * rowbytes);
            mbar_expect_tx(&sfull[sw], bytes);
            bulk_copy_g2s(area + ((size_t)sw * kMxSlice + lo) * a.pitch,
                          tokb + (row + lo) * rowbytes, bytes, &sfull[sw]);
          } else {
            mbar_arrive(&sfull[sw]);
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"((65536 - 128 * kProducerRegs) /
                                                              kTcConsumers / 8 * 8)
               : "memory");

  const int g = lane >> 2, t = lane & 3;
  const T* tok = static_cast<const T*>(a.tok);

  // (the cp.async path) The fetch cursor (f_*) runs kTcWStages - 1
  // chunks ahead of the products; a slice cursor (l_*) runs one slice ahead
  // of it, with its rows' mask bytes in flight, and loads the candidate of
  // the item after its own, so that no fetch waits on a load it issues.
  int l_s = 0, l_r = r0;
  long long l_row0 = 0;
  int l_next = 0;
  bool l_in[2] = {false, false};
  uint8_t l_m[2] = {0, 0};
  auto l_load = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = l_s * kMxSlice + g + 8 * h;
      l_in[h] = l_row0 >= 0 && rr < a.Tr;
      l_m[h] = l_in[h] ? a.mask[l_row0 + rr] : (uint8_t)0;
    }
  };
  int f_kc = 0;
  const T* fp[2] = {tok, tok};
  bool fok[2] = {false, false};
  auto f_take = [&]() {             // the fetch cursor takes l's slice; l moves on
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      fok[h] = l_in[h] && l_m[h] != 0;
      fp[h] = fok[h] ? tok + (l_row0 + l_s * kMxSlice + g + 8 * h) * a.D : tok;
    }
    if (++l_s == a.S) {
      l_s = 0;
      const int r = l_r + 1 == r1 ? r0 : l_r + 1;   // the next tile walks the run again
      l_row0 = item_row0(r, warp, l_next);
      l_r = r;
      l_next = item_raw(r + 1 < r1 ? r + 1 : r0, warp);
    }
    l_load();
  };
  auto fetch = [&](float* slot) {
    const int k0 = f_kc * kTcK + 8 * t;
    const T* p[2] = {fok[0] ? fp[0] + k0 : tok, fok[1] ? fp[1] + k0 : tok};
    tc_fetch_rows<T>(p, fok, k0, a.D, a.vec, slot);
    if (++f_kc == a.KC) {
      f_kc = 0;
      f_take();
    }
  };
  auto slot_of = [&](int it) {
    return wring + ((size_t)(it % kTcWStages) * kTcConsumers + threadIdx.x) * kTcWSlot;
  };
  if constexpr (!BULK) {
    l_row0 = item_row0(r0, warp, item_raw(r0, warp));
    l_next = item_raw(r0 + 1 < r1 ? r0 + 1 : r0, warp);
    l_load();
    f_take();
#pragma unroll 1
    for (int i = 0; i < kTcWStages - 1; ++i) {
      if (i < steps) fetch(slot_of(i));
      else cp_async_commit();
    }
  }

  float acc[N / 2], tot[N / 2], run[Tl::kR];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = tot[i] = 0.f;
#pragma unroll
  for (int i = 0; i < Tl::kR; ++i) run[i] = LEMUR_NEG;
  // (paged residual) a candidate without tokens scores the query's Tq_valid
  // NEGs summed in the CUDA-core kernel's order (lane l adds tokens l, l +
  // 32, .., then warp_sum), not in this body's column order, so that a pad
  // has the same bits whichever path its width takes
  float pad = 0.f;
  if constexpr (WALK) {
    for (int tq = lane; tq < a.Tq; tq += 32)
      if (a.q_mask[(size_t)gi * a.Tq + tq]) pad += LEMUR_NEG;
    pad = warp_sum(pad);
  }
  float cur[2][8];
  uint32_t A[2][Tl::kKsg][2][4];                   // [group & 1][k-step][hi, lo][register]
  int it = 0, us = 0, bst = 0, bpar = 0;       // steps; slices; (streaming) B stage, parity
  if (a.resident)
    for (int c = 0; c < nst; ++c) mbar_wait(&full[c], 0);
  for (int nt = 0; nt < a.NT; ++nt) {
    for (int r = r0; r < r1; ++r) {
      const long long row0 = item_row0(r, warp, item_raw(r, warp));
      int S = a.S;                                 // (paged: the round's, from its first slot)
      for (int s = 0; s < (WALK ? S : a.S); ++s, ++us) {
        // the slice's mask bytes and scales, for its epilogue: loaded now,
        // used after its last chunk (the bulk path: its slot's, later)
        bool e_in[2] = {false, false};
        uint8_t e_m[2] = {0, 0};
        float e_sc[2] = {1.f, 1.f};
        const int sw = warp * a.R + us % a.R;      // (bulk) the slice's slot
        const uint8_t* srow = area + ((size_t)sw * kMxSlice + g) * a.pitch;
        if constexpr (BULK) {
          mbar_wait(&sfull[sw], (us / a.R) & 1);
          if constexpr (RES) {
            if (s == 0) S = mx_res_smem<BITS>(a, mbits, mx_sm).mS[sw];
          } else if constexpr (PG) {
            if (s == 0) S = pg_S[sw];
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rr = s * kMxSlice + g + 8 * h;
            e_in[h] = row0 >= 0 && rr < a.Tr;
            e_m[h] = e_in[h] ? a.mask[row0 + rr] : (uint8_t)0;
            if constexpr (sizeof(T) == 1) {
              if (e_in[h]) e_sc[h] = __ldg(a.scales + row0 + rr);
            }
          }
        }
        for (int kc0 = 0; kc0 < a.KC; kc0 += kTcFlush) {
#pragma unroll
          for (int fc = 0; fc < kTcFlush; ++fc) {
            const int kc = kc0 + fc;
            if (kc < a.KC) {
              if constexpr (BULK) {
                mx_read_slot<T>(srow, a.pitch, kc * kTcK + 8 * t, a.D, a.vec == 0, cur);
              } else {
                if (it + kTcWStages - 1 < steps) fetch(slot_of(it + kTcWStages - 1));
                else cp_async_commit();
                cp_async_wait<kTcWStages - 1>();  // chunk it has landed
                tc_read<T>(slot_of(it), cur);
              }
              const int st = a.resident ? nt * a.KC + kc : bst;
              if (!a.resident) {                   // (resident: waited for once, below)
                mbar_wait(&full[st], bpar);
                if (++bst == nst) bst = 0, bpar ^= 1;
              }
              const uint64_t bdesc = smem_desc(stages + (size_t)st * Tl::kChunk, Tl::kLbo, 128);
#pragma unroll
              for (int gq = 0; gq < Tl::kGroups; ++gq) {
                const int buf = (fc * Tl::kGroups + gq) & 1;
                wgmma_wait<1>();                   // the group before last freed A[buf]
#pragma unroll
                for (int kk = 0; kk < Tl::kKsg; ++kk) tc_split<T>(cur, gq * Tl::kKsg + kk, A[buf][kk]);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < Tl::kKsg; ++kk) {
                  const int ks = gq * Tl::kKsg + kk;
                  // the k-step's B pieces: the chunk's descriptor plus its offset
                  const uint64_t dh = bdesc + (uint64_t)((2 * ks * Tl::kLbo) >> 4);
                  const uint64_t dl = dh + (uint64_t)((Tl::kPiece * 4) >> 4);
                  const int sd = (fc > 0 || ks > 0) ? 1 : 0;   // a sum starts from zero
                  if constexpr (sizeof(T) == 4) {
                    wgmma_tf32(acc, A[buf][kk][1], dh, sd);     // al . bh
                    wgmma_tf32(acc, A[buf][kk][0], dl, 1);      // ah . bl
                    wgmma_tf32(acc, A[buf][kk][0], dh, 1);      // ah . bh
                  } else {
                    wgmma_tf32(acc, A[buf][kk][0], dl, sd);     // a . bl
                    wgmma_tf32(acc, A[buf][kk][0], dh, 1);      // a . bh
                  }
                }
                wgmma_commit();
              }
              ++it;
            }
          }
          wgmma_wait<0>();
          fence_acc(acc);
          if (!a.resident && lane == 0) {          // the flush's chunks are free again
            const int nc = a.KC - kc0 < kTcFlush ? a.KC - kc0 : kTcFlush;
            for (int i = 1; i <= nc; ++i) mbar_arrive(&empty[(it - i) % nst]);
          }
#pragma unroll
          for (int i = 0; i < N / 2; ++i) tot[i] = kc0 == 0 ? acc[i] : tot[i] + acc[i];
        }

        // the slice's epilogue: the max over its valid rows, column by column
        bool ok[2];
        float sc[2];
        if constexpr (BULK) {
          const uint32_t bits = mbits[sw];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            ok[h] = (bits >> (g + 8 * h)) & 1u;
            sc[h] = PG ? 1.f : msc[sw * kMxSlice + g + 8 * h];
          }
          __syncwarp();                            // the slot is read: free it
          if (lane == 0) mbar_arrive(&sempty[sw]);
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            ok[h] = e_in[h] && e_m[h] != 0;
            sc[h] = e_sc[h];
          }
        }
        float v[Tl::kV];
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x0 = LEMUR_NEG, x1 = LEMUR_NEG;
            if constexpr (RES) {                   // the rows' q . centroid, two columns a load
              const float* qct = mx_res_smem<BITS>(a, mbits, mx_sm).qct + nt * N + 8 * j + 2 * t;
              const float2 q0 =
                  *reinterpret_cast<const float2*>(qct + (size_t)__float_as_int(sc[0]) * a.qcs);
              const float2 q1 =
                  *reinterpret_cast<const float2*>(qct + (size_t)__float_as_int(sc[1]) * a.qcs);
              if (ok[0]) x0 = tot[4 * j + c] + (c ? q0.y : q0.x);
              if (ok[1]) x1 = tot[4 * j + 2 + c] + (c ? q1.y : q1.x);
            } else if constexpr (sizeof(T) == 1) {
              if (ok[0]) x0 = tot[4 * j + c] * sc[0];
              if (ok[1]) x1 = tot[4 * j + 2 + c] * sc[1];
            } else {
              if (ok[0]) x0 = tot[4 * j + c];
              if (ok[1]) x1 = tot[4 * j + 2 + c];
            }
            v[2 * j + c] = fmaxf(x0, x1);
          }
        }
        float w[Tl::kR];
        mx_max_over_rows<Tl::kV>(v, lane, w);
#pragma unroll
        for (int i = 0; i < Tl::kR; ++i) run[i] = s == 0 ? w[i] : fmaxf(run[i], w[i]);
        if (s < (WALK ? S : a.S) - 1) continue;

        // the item's end; a lane holds columns 8 (e >> 1) + 2t + (e & 1), e = g kR + i
        if constexpr (KIND == kMxTokenMaxSim) {
          float* ob = ebuf + (r & 1) * N * (kMxWarps + 1);
#pragma unroll
          for (int i = 0; i < Tl::kR; ++i) {
            const int e = g * Tl::kR + i;
            ob[(8 * (e >> 1) + 2 * t + (e & 1)) * (kMxWarps + 1) + warp] = run[i];
          }
          // the round's 8 docs are done in every consumer warp; ob[r & 1] was
          // last read before the previous round's barrier
          asm volatile("bar.sync 1, %0;" ::"n"(kTcConsumers) : "memory");
          const int l0 = r * kMxWarps;
          for (int e = threadIdx.x; e < N * kMxWarps; e += kTcConsumers) {
            const int col = e / kMxWarps, w8 = e % kMxWarps;
            const long long xr = (long long)gi * N + col;
            if (xr < a.n && l0 + w8 < a.items)
              a.out[(size_t)xr * a.items + l0 + w8] = ob[col * (kMxWarps + 1) + w8];
          }
        } else {
          float ps = 0.f;
#pragma unroll
          for (int i = 0; i < Tl::kR; ++i) {
            const int e = g * Tl::kR + i;
            const int col = nt * N + 8 * (e >> 1) + 2 * t + (e & 1);
            if (col < a.Tq && a.q_mask[(size_t)gi * a.Tq + col]) ps += run[i];
          }
          ps = warp_sum(ps);
          const int ci = r * kMxWarps + warp;
          if (lane == 0 && ci < a.kp) {
            float* p = ebuf + (r - r0) * kMxWarps + warp;   // this warp's own slot
            float sum = nt == 0 ? ps : *p + ps;
            if (nt < a.NT - 1) {
              *p = sum;
            } else {
              if constexpr (WALK) {
                if (__ldg(a.gnt + (size_t)gi * a.kp + ci) == 0) sum = pad;
              }
              a.out[(size_t)gi * a.kp + ci] = sum;
            }
          }
        }
      }
    }
  }
}

// a.img (tc_image of the B rows), a.tok, a.mask, a.scales, a.out, a.D, a.Tr,
// a.NT, a.groups, a.runs, a.rounds, a.items and the kind's fields set.  The
// rerank takes the bulk path where B is resident, a token row is whole
// 16-byte units and 2 slices a consumer warp fit beside it.
template <typename T, int N, int KIND>
static int launch_maxsim_tc(MxArgs a, cudaStream_t stream) {
  using Tl = MxTile<N>;
  if (a.groups <= 0 || a.rounds <= 0 || a.NT <= 0) return (int)cudaSuccess;
  a.KC = tc_chunks(a.D) > 0 ? tc_chunks(a.D) : 1;
  a.S = a.Tr > 0 ? (a.Tr + kMxSlice - 1) / kMxSlice : 1;
  a.resident = a.NT * a.KC <= Tl::kStages;
  a.runs = a.runs < 1 ? 1 : (a.runs > a.rounds ? a.rounds : a.runs);
  const int per_block = (a.rounds + a.runs - 1) / a.runs;
  a.ebuf = KIND == kMxTokenMaxSim ? 2 * N * (kMxWarps + 1) : (per_block * kMxWarps + 1) / 2 * 2;
  const long long grid = (long long)a.groups * a.runs;
  if (grid >= (1LL << 31) || (long long)per_block * a.S * a.KC * a.NT >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return (int)err;
  const int nst = a.resident ? a.NT * a.KC : Tl::kStages;
  const size_t fixed = (size_t)nst * Tl::kChunk * sizeof(float) + a.ebuf * sizeof(float) +
                       2 * (size_t)nst * 8;
  const int rowbytes = a.D * (int)sizeof(T);
  bool bulk = false;
  if (KIND == kMxRerank && a.resident && a.D > 0 && rowbytes % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a.tok) % 16 == 0) {
    a.pitch = rowbytes;
    const size_t per_slot = (size_t)kMxSlice * a.pitch + kMxSlice * 4 + 4 + 16;
    const long long room = (long long)optin - (long long)fixed - 1024;
    const long long R = room > 0 ? room / (long long)(kMxWarps * per_slot) : 0;
    if (R >= 2) {
      bulk = true;
      a.R = R < 8 ? (int)R : 8;
      a.abytes = (int)(((size_t)kMxWarps * a.R * (kMxSlice * a.pitch + kMxSlice * 4 + 4) + 15) /
                       16 * 16);
      a.vec = a.D % kTcK == 0;                     // whole chunks: no column past D is read
    }
  }
  if (!bulk) {
    const uintptr_t align = sizeof(T) == 4 ? 16 : 8;
    a.vec = a.D > 0 && a.D % kTcK == 0 && reinterpret_cast<uintptr_t>(a.tok) % align == 0;
    a.R = 0;
    a.pitch = 0;
    a.abytes = kMxAFloats * (int)sizeof(float);
  }
  const size_t smem = fixed + a.abytes + (bulk ? 2 * (size_t)kMxWarps * a.R * 8 : 0);
  auto kernel = bulk ? maxsim_tc_kernel<T, N, KIND, KIND == kMxRerank>
                     : maxsim_tc_kernel<T, N, KIND, false>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, kTcThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The paged residual rerank's layout (a.D, a.Tq, a.NT, a.ncent, a.db, a.kp
// and the counts set): B resident, kMxPgStages staging pages a producer
// warp, a.R slots a consumer warp (2 to 4, as many as fit).  Returns the
// block's shared memory in bytes, or 0 where the layout does not fit the
// card's (the caller takes the CUDA-core rerank).
template <int N>
static size_t mx_res_layout(MxResArgs& a, int bits, int optin) {
  using Tl = MxTile<N>;
  a.KC = tc_chunks(a.D) > 0 ? tc_chunks(a.D) : 1;
  a.S = 1;
  a.resident = a.NT * a.KC <= Tl::kStages;
  if (!a.resident || a.D <= 0) return 0;
  a.runs = a.runs < 1 ? 1 : (a.runs > a.rounds ? a.rounds : a.runs);
  const int per_block = (a.rounds + a.runs - 1) / a.runs;
  a.ebuf = (per_block * kMxWarps + 1) / 2 * 2;
  a.pitch = (a.KC * kTcK + 4) * (int)sizeof(float);  // whole chunks and a pad: rows off banks
  a.vec = a.D % kTcK == 0;
  a.qcs = a.NT * N + 2;                      // even: two columns a load, rows off banks
  a.vstride = (a.D + a.D / 32 + 31) / 32 * 32;
  a.stage_bytes = (kMxSlice * a.db + 64 + 15) / 16 * 16 + 16;
  const size_t fixed = (size_t)a.NT * a.KC * Tl::kChunk * sizeof(float) +
                       a.ebuf * sizeof(float) + 2 * (size_t)a.NT * a.KC * 8;
  const size_t tables = ((size_t)a.ncent * a.qcs + (size_t)(1 << bits) * a.vstride) * 4 + 16 +
                        (size_t)(kTcThreads - kTcConsumers) / 32 * kMxPgStages * a.stage_bytes;
  const size_t per_r = (size_t)kMxWarps * (kMxSlice * a.pitch + kMxSlice * 4 + 8 + 16);
  const long long room = (long long)optin - (long long)(fixed + tables) - 1024;
  const long long R = room > 0 ? room / (long long)per_r : 0;
  if (R < 2) return 0;
  a.R = R < 4 ? (int)R : 4;
  a.abytes = (int)((a.R * (size_t)kMxWarps * (kMxSlice * a.pitch + kMxSlice * 4 + 8) + tables +
                    15) / 16 * 16);
  return fixed + a.abytes + 2 * (size_t)kMxWarps * a.R * 8;
}

template <int N, int BITS>
static int launch_maxsim_tc_res(MxResArgs a, size_t smem, cudaStream_t stream) {
  if (a.groups <= 0 || a.rounds <= 0) return (int)cudaSuccess;
  const long long grid = (long long)a.groups * a.runs;
  if (grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  auto kernel = maxsim_tc_kernel<float, N, kMxRerankRes, true, BITS>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, kTcThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The paged fp32 rerank's layout (a.D, a.NT, a.kp and the counts set): B
// resident, a.R slots a consumer warp (2 to kMxPgSlots, as many as fit), a
// slot's rows D x 4 bytes apart, as in the page (one bulk copy: D % 4 == 0).
// Returns the block's shared memory in bytes, or 0 where the layout does
// not fit the card's (the caller takes the CUDA-core rerank).
template <int N>
static size_t mx_pg_layout(MxResArgs& a, int optin) {
  using Tl = MxTile<N>;
  a.KC = tc_chunks(a.D) > 0 ? tc_chunks(a.D) : 1;
  a.S = 1;
  a.resident = a.NT * a.KC <= Tl::kStages;
  if (!a.resident || a.D <= 0 || a.D % 4) return 0;
  a.runs = a.runs < 1 ? 1 : (a.runs > a.rounds ? a.rounds : a.runs);
  const int per_block = (a.rounds + a.runs - 1) / a.runs;
  a.ebuf = a.NT > 1 ? (per_block * kMxWarps + 1) / 2 * 2 : 2;   // (sums across query tiles)
  a.pitch = a.D * (int)sizeof(float);
  a.vec = a.D % kTcK == 0;
  const size_t fixed = (size_t)a.NT * a.KC * Tl::kChunk * sizeof(float) +
                       a.ebuf * sizeof(float) + 2 * (size_t)a.NT * a.KC * 8;
  const size_t per_r = (size_t)kMxWarps * (kMxSlice * a.pitch + 4 + 4 + 16);
  const long long room = (long long)optin - (long long)fixed - 1024;
  const long long R = room > 0 ? room / (long long)per_r : 0;
  if (R < 2) return 0;
  a.R = R < kMxPgSlots ? (int)R : kMxPgSlots;
  a.abytes = (int)(((size_t)a.R * kMxWarps * (kMxSlice * a.pitch + 4 + 4) + 15) / 16 * 16);
  return fixed + a.abytes + 2 * (size_t)kMxWarps * a.R * 8;
}

template <int N>
static int launch_maxsim_tc_pg(MxResArgs a, size_t smem, cudaStream_t stream) {
  if (a.groups <= 0 || a.rounds <= 0) return (int)cudaSuccess;
  const long long grid = (long long)a.groups * a.runs;
  if (grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  auto kernel = maxsim_tc_kernel<float, N, kMxRerankPaged, true>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, kTcThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
