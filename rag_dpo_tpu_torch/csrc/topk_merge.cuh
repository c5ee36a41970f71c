// The running top-k merge of the selectors csrc/fused_topk.cu (K4) and
// csrc/ell_topk.cu (K3, its pass 2): one warp keeps a sorted list of the
// best k (score, key) pairs, the key breaking ties lowest first (K4: the row,
// ROADMAP C-13; K3: the candidate's position, which is C-1's order). New
// entries arrive 128 at a time; those that beat the k-th key are compacted by
// a ballot and merged in by rank. The list may live in shared or in global
// memory (generic pointers, never read through the read-only cache), so k
// has no bound. No atomics: the same inputs give the same bits.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMergeN = 128;           // entries a filter takes
constexpr int kPer = kMergeN / 32;     // of them a lane

__device__ __forceinline__ bool better(float s1, int r1, float s2, int r2) {
  return s1 > s2 || (s1 == s2 && r1 < r2);
}

// Merge p (<= 128) new entries (ps/pi, any order) into the sorted running
// list (ls/li, cnt entries, in shared or global memory) of one query; keeps
// the best k by (-score, row). One warp; returns the new count. The list
// moves from its end down in 32-entry chunks, each read whole before it is
// written, and only below the best new entry's rank: an entry at i goes to
// i + (new entries better than it), never onto one not yet read.
__device__ int warp_merge(float* ls, int* li, int cnt, const float* ps,
                          const int* pi, int p, int k, int lane) {
  float pv[kPer];
  int pr[kPer], prank[kPer];
  int low = k;  // the best new entry's rank
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int j = lane + 32 * t;
    prank[t] = k;
    if (j < p) {
      const float s = ps[j];
      const int r = pi[j];
      int lo = 0, hi = cnt;  // running entries with a better key
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (better(ls[mid], li[mid], s, r)) lo = mid + 1; else hi = mid;
      }
      int rank = lo;
      for (int u = 0; u < p; ++u) rank += better(ps[u], pi[u], s, r);
      pv[t] = s; pr[t] = r; prank[t] = rank;
      low = min(low, rank);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    low = min(low, __shfl_xor_sync(0xffffffffu, low, off));
  for (int c0 = ((cnt - 1) >> 5) << 5; c0 >= 0 && c0 + 31 >= low; c0 -= 32) {
    const int i = c0 + lane;
    float s = 0.f;
    int r = 0, rank = k;
    if (i < cnt && i >= low) {
      s = ls[i]; r = li[i];
      rank = i;
      for (int u = 0; u < p; ++u) rank += better(ps[u], pi[u], s, r);
    }
    __syncwarp();
    if (rank < k && rank != i) { ls[rank] = s; li[rank] = r; }
    __syncwarp();
  }
#pragma unroll
  for (int t = 0; t < kPer; ++t)
    if (prank[t] < k) { ls[prank[t]] = pv[t]; li[prank[t]] = pr[t]; }
  __syncwarp();
  return min(k, cnt + p);
}

// warp_merge for k <= 64 (every timed path has k 40) and a few new entries,
// which is what a tile brings once the list has filled: the list sits in
// two registers a lane (entries lane and lane + 32). Each new entry,
// broadcast in turn, gets its rank from two ballots over the list and kPer
// over the new entries, and each list entry counts the new ones better than
// it: no binary search, no chain of dependent shared loads. The same ranks
// as warp_merge, so the same list.
__device__ int warp_merge_small(float* ls, int* li, int cnt, const float* ps,
                                const int* pi, int p, int k, int lane) {
  float lv[2], pv[kPer];
  int lr[2], shift[2] = {0, 0}, pr[kPer], prank[kPer];
  bool have[2], pin[kPer];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    have[h] = i < cnt;
    lv[h] = have[h] ? ls[i] : 0.f;
    lr[h] = have[h] ? li[i] : 0;
  }
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int j = lane + 32 * t;
    pin[t] = j < p;
    pv[t] = pin[t] ? ps[j] : 0.f;
    pr[t] = pin[t] ? pi[j] : 0;
    prank[t] = k;
  }
  for (int j = 0; j < p; ++j) {
    const float s = ps[j];
    const int r = pi[j];
    int rank = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rank += __popc(__ballot_sync(0xffffffffu,
                                   have[h] && better(lv[h], lr[h], s, r)));
      shift[h] += have[h] && better(s, r, lv[h], lr[h]);
    }
#pragma unroll
    for (int t = 0; t < kPer; ++t)
      rank += __popc(__ballot_sync(0xffffffffu,
                                   pin[t] && better(pv[t], pr[t], s, r)));
#pragma unroll
    for (int t = 0; t < kPer; ++t)
      if (j == lane + 32 * t) prank[t] = rank;
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rank = lane + 32 * h + shift[h];
    if (have[h] && rank < k) { ls[rank] = lv[h]; li[rank] = lr[h]; }
  }
#pragma unroll
  for (int t = 0; t < kPer; ++t)
    if (pin[t] && prank[t] < k) { ls[prank[t]] = pv[t]; li[prank[t]] = pr[t]; }
  __syncwarp();
  return min(k, cnt + p);
}

// One warp: the entries of `s`/`rows` (kPer a lane) that beat the running
// k-th key (ts, ti) go to the warp's pending buffer, then merge. Returns
// the new count; ls[k - 1] is the new k-th key once it is k.
__device__ int filter_merge(float* ls, int* li, int cnt, float ts, int ti,
                            float* ps, int* pi, const float* s,
                            const int* rows, const bool* ok, int k,
                            int lane) {
  int p = 0;
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const bool pass = ok[m] && better(s[m], rows[m], ts, ti);
    const unsigned ball = __ballot_sync(0xffffffffu, pass);
    if (pass) {
      const int pos = p + __popc(ball & ((1u << lane) - 1u));
      ps[pos] = s[m];
      pi[pos] = rows[m];
    }
    p += __popc(ball);
  }
  __syncwarp();
  if (p == 0) return cnt;
  if (k <= 64 && p <= 8)
    return warp_merge_small(ls, li, cnt, ps, pi, p, k, lane);
  return warp_merge(ls, li, cnt, ps, pi, p, k, lane);
}

}  // namespace
