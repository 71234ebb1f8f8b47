// A block's running top-k over tiles of (score, id) candidates, shared by
// K1's select epilogue (flat_scan.cu) and the merge of its candidates
// (topk_select.cu).
//
// Order: a higher score first, then a lower id, so that the result is one
// sequence whatever order the tiles arrive in. A slot that holds nothing
// is (-inf, -1), and such a pair never enters: the select keeps at most the
// valid candidates and pads the rest.
//
// Per tile of at most kSelectTile candidates (one a thread of a 256-thread
// block), in shared memory:
//   1. threshold: a candidate enters only if it ranks before the current
//      k-th entry, one compare against a broadcast value. After the first
//      tile this rejects most rows (at k = 10 about k of each next 256).
//   2. compaction of the survivors to the tile's front (warp ballots and a
//      prefix over the 8 warps' counts; no atomics, so the order is fixed);
//   3. a bitonic sort of the survivors, padded to a power of two, in
//      shared memory (log2(P) (log2(P) + 1) / 2 steps, P the padded count);
//   4. a merge-path merge of the sorted survivors with the sorted top-k:
//      each element finds its place in the other sequence by binary search
//      and writes itself to the other top-k buffer, the first k only.
// A tile with no survivor costs one compare a thread and two barriers.
// Every call is made by all threads of the block with the same arguments.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

constexpr int kSelectThreads = 256;  // the block size of every selecting kernel
constexpr int kSelectTile = kSelectThreads;
constexpr int kSelectWarps = kSelectThreads / 32;
constexpr int kSelectMaxK = 256;
constexpr int kPadId = 0x7fffffff;  // sorts after every real id

__device__ __forceinline__ bool ranks_before(float a, int ai, float b, int bi) {
  return a > b || (a == b && ai < bi);
}

// 6,180 bytes: the shared memory of a selecting block, whatever its k.
struct TopKShared {
  float tile_s[kSelectTile];
  int tile_i[kSelectTile];
  float top_s[2][kSelectMaxK];
  int top_i[2][kSelectMaxK];
  int warp_count[kSelectWarps];
  int cur;  // which top buffer holds the running top-k
};

// The calls take k (1 <= k <= kSelectMaxK) each time and keep no state in
// registers: a scan that merges between tiles holds only its own live
// values across the merge.

// The running top-k starts as (-inf, -1), or as a sorted (by
// ranks_before) k-entry sequence from memory. Visible to the block at the
// first topk_merge_tile's barrier.
__device__ __forceinline__ void topk_init(TopKShared& sh, int k, const float* s,
                                          const int32_t* ids) {
  const int t = threadIdx.x;
  if (t < k) {
    sh.top_s[0][t] = s ? s[t] : neg_inf();
    sh.top_i[0][t] = s ? ids[t] : -1;
  }
  if (t == 0) sh.cur = 0;
}

// Merge the tile's first n entries (sh.tile_s / sh.tile_i, written by any
// threads of the block since the last call) into the running top-k.
__device__ __forceinline__ void topk_merge_tile(TopKShared& sh, int k, int n) {
  __syncthreads();
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int cur = sh.cur;
  const float th_s = sh.top_s[cur][k - 1];
  const int th_i = sh.top_i[cur][k - 1];
  float v = 0.f;
  int vi = 0;
  bool keep = false;
  if (t < n) {
    v = sh.tile_s[t];
    vi = sh.tile_i[t];
    keep = ranks_before(v, vi, th_s, th_i);
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) sh.warp_count[warp] = __popc(ballot);
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kSelectWarps; ++w) {
    const int c = sh.warp_count[w];
    base += w < warp ? c : 0;
    total += c;
  }
  if (total == 0) return;  // every read of this tile is behind the barrier
  // the survivors to the front, every read of the tile being done
  if (keep) {
    const int p = base + __popc(ballot & ((1u << lane) - 1u));
    sh.tile_s[p] = v;
    sh.tile_i[p] = vi;
  }
  int P = 1;
  while (P < total) P <<= 1;
  if (t >= total && t < P) {
    sh.tile_s[t] = neg_inf();
    sh.tile_i[t] = kPadId;
  }
  // bitonic sort of [0, P), descending by ranks_before
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      if (t < (P >> 1)) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const float a = sh.tile_s[lo], b = sh.tile_s[hi];
        const int ai = sh.tile_i[lo], bi = sh.tile_i[hi];
        const bool swap = (lo & size) == 0 ? ranks_before(b, bi, a, ai)
                                           : ranks_before(a, ai, b, bi);
        if (swap) {
          sh.tile_s[lo] = b;
          sh.tile_s[hi] = a;
          sh.tile_i[lo] = bi;
          sh.tile_i[hi] = ai;
        }
      }
    }
  }
  __syncthreads();
  // merge path: an element's place is its index plus the count of the
  // other sequence's elements before it (the top-k's win ties)
  const int nxt = cur ^ 1;
  const float* ts = sh.top_s[cur];
  const int* ti = sh.top_i[cur];
  if (t < total) {
    const float c = sh.tile_s[t];
    const int ci = sh.tile_i[t];
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ranks_before(c, ci, ts[mid], ti[mid])) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    if (t + lo < k) {
      sh.top_s[nxt][t + lo] = c;
      sh.top_i[nxt][t + lo] = ci;
    }
  }
  if (t < k) {
    const float a = ts[t];
    const int ai = ti[t];
    int lo = 0, hi = total;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ranks_before(sh.tile_s[mid], sh.tile_i[mid], a, ai)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (t + lo < k) {
      sh.top_s[nxt][t + lo] = a;
      sh.top_i[nxt][t + lo] = ai;
    }
  }
  __syncthreads();
  if (t == 0) sh.cur = nxt;  // read again only behind the next barrier
}

// The k entries, best first, to s[0, k) and ids[0, k).
__device__ __forceinline__ void topk_store(TopKShared& sh, int k, float* s, int32_t* ids) {
  __syncthreads();
  const int t = threadIdx.x;
  if (t < k) {
    s[t] = sh.top_s[sh.cur][t];
    ids[t] = sh.top_i[sh.cur][t];
  }
}

// The widest candidate set topk_store_short sorts: one warp's lanes.
constexpr int kShortSelect = 32;

// In place of topk_init / topk_merge_tile / topk_store, for a set of at
// most kShortSelect candidates (tile_s / tile_i [0, n), written by any
// threads of the block): the best k of them, as topk_store writes them.
// A pair of a few rows (the sq8 tiers hold 4-8 a list on average) would
// otherwise pay the merge's dozen barriers for a handful of rows, with
// one block an SM and nothing to hide them; here warp 0 sorts the set in
// registers (a bitonic network over shuffles) behind a single barrier.
__device__ __forceinline__ void topk_store_short(const TopKShared& sh, int k, int n, float* s,
                                                 int32_t* ids) {
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= kShortSelect) {
    if (t < k) {
      s[t] = neg_inf();
      ids[t] = -1;
    }
    return;
  }
  float v = neg_inf();
  int vi = kPadId;
  if (t < n && ranks_before(sh.tile_s[t], sh.tile_i[t], neg_inf(), -1)) {
    v = sh.tile_s[t];
    vi = sh.tile_i[t];
  }
  // best first over the warp; the lower lane of a pair keeps the better
  // entry in a best-first run and the worse in the other runs
#pragma unroll
  for (int size = 2; size <= kShortSelect; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, stride);
      const int oi = __shfl_xor_sync(0xffffffffu, vi, stride);
      const bool better_low = ((t & stride) == 0) == ((t & size) == 0);
      if (better_low ? ranks_before(o, oi, v, vi) : ranks_before(v, vi, o, oi)) {
        v = o;
        vi = oi;
      }
    }
  }
  if (t < k) {
    s[t] = v;
    ids[t] = vi == kPadId ? -1 : vi;
  }
}

}  // namespace
