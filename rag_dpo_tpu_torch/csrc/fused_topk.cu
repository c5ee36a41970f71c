// Exact dense top-k for Hopper (sm_90a): [Q,D]·[N,D]ᵀ (+ penalty) reduced to
// the k best rows of each query without ever writing the [Q,N] scores.
//
// Replaces the Pallas TPU kernel rag_dpo_tpu/ops/topk.py::fused_topk
// (_fused_topk_kernel with streaming_topk_update and _rank_merge), and takes
// the place of the XLA selectors approx_topk / blocked_topk on the card.
//
//   score[q, n] = sum_d q[q, d] * e[n, d]  (+ pen[n]; rows n >= P get -5e29)
//
// Inputs are f32 or bf16 (widened exactly to f32); each thread sums its
// products in d order with f32 fused multiply-adds. Order among equal scores
// is the lowest row first, i.e. rows are ranked by the key (-score, row),
// which is what lax.top_k and the CPU approx_max_k give the store (ROADMAP
// C-2, C-13). Slots past N come out as (-1e30, -1).
//
// Pass 1, grid (row chunks, query tiles), 256 threads. A block walks its
// chunk of rows in 128-row tiles. Per tile: a SIMT product of the query tile
// (16 or 64 queries) with the 128 rows (csrc/tile_product.cuh: D in 32-wide
// slices staged through shared memory as f32, the next slice loaded into
// registers while the current one is multiplied), each thread holding 1x8 or
// 4x8 sums; then one
// warp per query keeps a sorted running top-k in shared memory: the tile's
// scores that beat the running k-th key are compacted by a ballot and merged
// in by rank (binary search into the running list, pairwise among the new
// ones). Each block writes its sorted list. Pass 2, one warp per query, runs
// the same filter and merge over the blocks' lists. No atomics: the same
// inputs give the same bits.
//
// What bounds it on an H100: the products. 2·Q·N·D flops on the CUDA cores
// in f32 (67 TFLOP/s) against bytes N·D·sizeof(T) read once (3.35 TB/s):
// at bf16 the operations bound it from Q ~ 10 up. The running-list filter
// costs a compare per score once the list is full; merges are rare after the
// first tiles. wgmma (bf16 products are exact in f32) is for a later PR.

#include <math.h>

#include "tile_product.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kLdS = kTileN + 1;      // padded row of the score tile
constexpr int kMaxK = 256;
constexpr float kNegInf = -1e30f;
constexpr float kPastPenalty = -5e29f;

__device__ __forceinline__ bool better(float s1, int r1, float s2, int r2) {
  return s1 > s2 || (s1 == s2 && r1 < r2);
}

// Merge p new entries (ps/pi, any order) into the sorted running list
// (ls/li, cnt entries) of one query; keeps the best k by (-score, row).
// One warp; returns the new count.
__device__ int warp_merge(float* ls, int* li, int cnt, const float* ps,
                          const int* pi, int p, int k, int lane) {
  constexpr int kPer = kTileN / 32, kRun = kMaxK / 32;
  float pv[kPer], lv[kRun];
  int pr[kPer], prank[kPer], lr[kRun], lrank[kRun];
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
    }
  }
#pragma unroll
  for (int t = 0; t < kRun; ++t) {
    const int i = lane + 32 * t;
    lrank[t] = k;
    if (i < cnt) {
      const float s = ls[i];
      const int r = li[i];
      int rank = i;
      for (int u = 0; u < p; ++u) rank += better(ps[u], pi[u], s, r);
      lv[t] = s; lr[t] = r; lrank[t] = rank;
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < kRun; ++t)
    if (lrank[t] < k) { ls[lrank[t]] = lv[t]; li[lrank[t]] = lr[t]; }
#pragma unroll
  for (int t = 0; t < kPer; ++t)
    if (prank[t] < k) { ls[prank[t]] = pv[t]; li[prank[t]] = pr[t]; }
  __syncwarp();
  return min(k, cnt + p);
}

// One warp: the entries of `s`/`rows` (32·kPer of them, lane-major) that
// beat the running k-th key go to the warp's pending buffer, then merge.
__device__ int filter_merge(float* ls, int* li, int cnt, float* ps, int* pi,
                            const float* s, const int* rows, const bool* ok,
                            int k, int lane) {
  constexpr int kPer = kTileN / 32;
  float ts = -INFINITY;
  int ti = 0x7fffffff;
  if (cnt == k) { ts = ls[k - 1]; ti = li[k - 1]; }
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
  return warp_merge(ls, li, cnt, ps, pi, p, k, lane);
}

template <typename T, int MQ>
__global__ void __launch_bounds__(kThreads, 2)
topk_tiles(const T* __restrict__ q, const T* __restrict__ e,
           const float* __restrict__ pen, int P, int Q, int N, int D, int k,
           int rows_per_block, float* __restrict__ cand_s,
           int* __restrict__ cand_i) {
  constexpr int TQ = 16 * MQ;
  constexpr int kLdQ = TQ + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);       // [kChunk][kLdQ]
  float* es = qs + kChunk * kLdQ;                     // [kChunk][kLdE]
  float* sc = es + kChunk * kLdE;                     // [TQ][kLdS]
  float* ls = sc + TQ * kLdS;                         // [TQ][k]
  int* li = reinterpret_cast<int*>(ls + TQ * k);      // [TQ][k]
  float* ps = reinterpret_cast<float*>(li + TQ * k);  // [kWarps][kTileN]
  int* pi = reinterpret_cast<int*>(ps + kWarps * kTileN);
  int* lcnt = pi + kWarps * kTileN;                   // [TQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.y * TQ;
  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(N, row_begin + rows_per_block);
  for (int i = tid; i < TQ; i += kThreads) lcnt[i] = 0;

  for (int base = row_begin; base < row_end; base += kTileN) {
    float acc[MQ][8];
    tile_product<T, MQ>(q, e, Q, N, D, q0, base, tid, qs, es, acc);

    // scores (+ penalty) to the shared tile
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tile_col(tx, j);
      float add = 0.f;
      if (pen != nullptr) add = base + r < P ? pen[base + r] : kPastPenalty;
#pragma unroll
      for (int i = 0; i < MQ; ++i) {
        const float s = pen != nullptr ? acc[i][j] + add : acc[i][j];
        sc[(ty * MQ + i) * kLdS + r] = s;
      }
    }
    __syncthreads();

    for (int qi = warp; qi < TQ; qi += kWarps) {
      if (q0 + qi >= Q) break;
      float s[kTileN / 32];
      int rows[kTileN / 32];
      bool ok[kTileN / 32];
#pragma unroll
      for (int m = 0; m < kTileN / 32; ++m) {
        const int r = m * 32 + lane;
        s[m] = sc[qi * kLdS + r];
        rows[m] = base + r;
        ok[m] = base + r < row_end;
      }
      const int cnt = filter_merge(ls + qi * k, li + qi * k, lcnt[qi],
                                   ps + warp * kTileN, pi + warp * kTileN, s,
                                   rows, ok, k, lane);
      if (lane == 0) lcnt[qi] = cnt;
      __syncwarp();
    }
    __syncthreads();
  }

  for (int qi = warp; qi < TQ; qi += kWarps) {
    if (q0 + qi >= Q) break;
    const int cnt = lcnt[qi];
    const size_t off =
        (static_cast<size_t>(q0 + qi) * gridDim.x + blockIdx.x) * k;
    for (int i = lane; i < k; i += 32) {
      cand_s[off + i] = i < cnt ? ls[qi * k + i] : -INFINITY;
      cand_i[off + i] = i < cnt ? li[qi * k + i] : -1;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
topk_merge(const float* __restrict__ cand_s, const int* __restrict__ cand_i,
           int m, int Q, int k, float* __restrict__ out_s,
           int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  float* ls = reinterpret_cast<float*>(smem4);        // [kWarps][k]
  int* li = reinterpret_cast<int*>(ls + kWarps * k);  // [kWarps][k]
  float* ps = reinterpret_cast<float*>(li + kWarps * k);
  int* pi = reinterpret_cast<int*>(ps + kWarps * kTileN);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qg = blockIdx.x * kWarps + warp;
  if (qg >= Q) return;  // whole warps leave; no block barrier follows
  float* wl = ls + warp * k;
  int* wi = li + warp * k;
  const float* cs = cand_s + static_cast<size_t>(qg) * m;
  const int* ci = cand_i + static_cast<size_t>(qg) * m;
  int cnt = 0;
  for (int base = 0; base < m; base += kTileN) {
    float s[kTileN / 32];
    int rows[kTileN / 32];
    bool ok[kTileN / 32];
#pragma unroll
    for (int t = 0; t < kTileN / 32; ++t) {
      const int j = base + t * 32 + lane;
      s[t] = j < m ? cs[j] : -INFINITY;
      rows[t] = j < m ? ci[j] : -1;
      ok[t] = rows[t] >= 0;
    }
    cnt = filter_merge(wl, wi, cnt, ps + warp * kTileN, pi + warp * kTileN,
                       s, rows, ok, k, lane);
  }
  for (int i = lane; i < k; i += 32) {
    out_s[static_cast<size_t>(qg) * k + i] = i < cnt ? wl[i] : kNegInf;
    out_i[static_cast<size_t>(qg) * k + i] = i < cnt ? wi[i] : -1;
  }
}

template <typename T, int MQ>
cudaError_t launch_tiles(const void* q, const void* e, const float* pen,
                         int P, int Q, int N, int D, int k, int rpb, int S,
                         float* cand_s, int* cand_i, cudaStream_t st) {
  constexpr int TQ = 16 * MQ;
  const size_t smem =
      sizeof(float) * (product_smem_floats<MQ>() + TQ * kLdS) +
      8 * static_cast<size_t>(TQ) * k + 8 * kWarps * kTileN + 4 * TQ;
  cudaError_t err = cudaFuncSetAttribute(
      topk_tiles<T, MQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(S, (Q + TQ - 1) / TQ);
  topk_tiles<T, MQ><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(e), pen, P, Q, N, D, k,
      rpb, cand_s, cand_i);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tiles_for(int Q, const void* q, const void* e,
                             const float* pen, int P, int N, int D, int k,
                             int rpb, int S, float* cand_s, int* cand_i,
                             cudaStream_t st) {
  if (Q <= 16)
    return launch_tiles<T, 1>(q, e, pen, P, Q, N, D, k, rpb, S, cand_s,
                              cand_i, st);
  return launch_tiles<T, 4>(q, e, pen, P, Q, N, D, k, rpb, S, cand_s, cand_i,
                            st);
}

}  // namespace

extern "C" {

// dtype 0 = f32, 1 = bf16 (q and e alike); q [Q, D], e [N, D], both
// contiguous and 16-byte aligned; penalty [P] f32 or null; cand_* [Q, S, k]
// scratch with S = ceil(N / rows_per_block); out_* [Q, k]. Needs
// 8 <= D <= 1024 with D % 8 == 0, 1 <= k <= 256, rows_per_block a positive
// multiple of 128. Returns a cudaError_t.
int fused_topk(int dtype, const void* q, const void* e, const float* penalty,
               int P, int Q, int N, int D, int k, int rows_per_block,
               float* cand_s, int* cand_i, float* out_s, int* out_i,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q <= 0 || N <= 0 || D < 8 || D > 1024 || D % 8 != 0 || k <= 0 ||
      k > kMaxK || rows_per_block <= 0 || rows_per_block % kTileN != 0 ||
      (dtype != 0 && dtype != 1) || (penalty != nullptr && P < 0))
    return cudaErrorInvalidValue;
  const int S = (N + rows_per_block - 1) / rows_per_block;
  cudaError_t err =
      dtype == 0
          ? launch_tiles_for<float>(Q, q, e, penalty, P, N, D, k,
                                    rows_per_block, S, cand_s, cand_i, st)
          : launch_tiles_for<__nv_bfloat16>(Q, q, e, penalty, P, N, D, k,
                                            rows_per_block, S, cand_s, cand_i,
                                            st);
  if (err != cudaSuccess) return err;
  const size_t smem = 8 * static_cast<size_t>(kWarps) * (k + kTileN);
  err = cudaFuncSetAttribute(topk_merge,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  topk_merge<<<(Q + kWarps - 1) / kWarps, kThreads, smem, st>>>(
      cand_s, cand_i, S * k, Q, k, out_s, out_i);
  return cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
