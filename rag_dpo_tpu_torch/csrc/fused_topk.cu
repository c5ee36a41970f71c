// Exact dense top-k for Hopper (sm_90a): [Q,D]·[N,D]ᵀ (+ penalty) reduced to
// the k best rows of each query without ever writing the [Q,N] scores.
//
// Replaces the Pallas TPU kernel rag_dpo_tpu/ops/topk.py::fused_topk
// (_fused_topk_kernel with streaming_topk_update and _rank_merge), and takes
// the place of the XLA selectors approx_topk / blocked_topk on the card.
//
//   score[q, n] = sum_d q[q, d] * e[n, d]  (+ pen[n]; rows n >= P get -5e29)
//
// Order among equal scores is the lowest row first, i.e. rows are ranked by
// the key (-score, row), which is what lax.top_k and the CPU approx_max_k
// give the store (ROADMAP C-2, C-13). Slots past N come out as (-1e30, -1).
// Any 1 <= k and any D % 8 == 0 run.
//
// Pass 1, grid (query tiles, row chunks). A block walks its chunk of rows in
// 128-row tiles and keeps, for each query of its tile, a sorted running
// top-k: per tile the product lands in a [TQ][128] score tile (plus the
// penalty, one f32 add), then one warp per query compacts by a ballot the
// scores that beat the query's running k-th key and merges them in by rank
// (binary search into the running list, pairwise among the new ones; for
// k <= 64 and a few new entries, ballots over the list held in registers).
// On bf16 inputs a query none of whose scores beats its k-th key is not
// selected at all. The lists live in shared memory when they fit and
// otherwise in the block's slice of the candidate scratch, through the same
// code. Each block leaves its sorted list there. Pass 2, one warp per
// query, runs the same filter and merge over the blocks' lists. No
// atomics: the same inputs give the same bits.
//
// The product:
// * bf16 inputs (the store's default image, every serve-path call): the
//   tensor-core product of csrc/tma_product.cuh, TMA-fed wgmma with the
//   query tile (8 ... 128, a multiple of 8) as the N side; 256 consumer
//   threads and a producer warp. A block is persistent over its chunk, so
//   one tile's epilogue overlaps the next tile's loads; the query tiles of a
//   chunk are neighbours in the grid and read its rows from L2 together.
// * f32 inputs (the scale phase's exact oracle, f32 stores): the SIMT FMA
//   chain of csrc/tile_product.cuh, 16 or 64 queries, 256 threads. TF32
//   would give up the precision ROADMAP C-5 keeps.
//
// What bounds it on an H100: the bytes. At Q 256 over 1M × 1024 bf16 rows,
// 2.05 GB read once take 0.613 ms at 3.35 TB/s, and the 5.4e11 products
// 0.543 ms on the bf16 tensor cores (989 TFLOP/s): the redesign moves the
// product there from the CUDA cores (67 TFLOP/s in f32, 8 ms), keeps at
// least three D slices of rows in flight per SM, and reads the rows once
// for all query tiles of a chunk through L2. What it does not remove: the
// query tile travels again with every 128-row tile, and each of Q/128
// query tiles reads the rows into shared memory, 8.2 GB at Q 256 (PERF.md).
// With random rows a query's list still changes in most tiles, so the
// selection is kept cheap rather than rare.

#include <math.h>
#include <string.h>

#include "tile_product.cuh"
#include "tma_product.cuh"
#include "topk_merge.cuh"

namespace {

static_assert(kTileN == kMergeN, "a tile of scores is one merge's input");
constexpr int kWarps = kThreads / 32;  // the eight warps that select
constexpr int kLdS = kTileN + 1;       // padded row of the SIMT score tile
constexpr int kLdT = kTileN + 4;       // of the wgmma score tile
constexpr float kNegInf = -1e30f;
constexpr float kPastPenalty = -5e29f;
constexpr int kMaxSmem = 232448;

// Per-query selection state of a pass-1 block: the count and k-th key of
// each running list, the warps' pending buffers, and where the lists live.
struct Lists {
  float* ls;     // shared [TQ][k], or null: the block's cand_* slice
  int* li;
  int* cnt;      // [TQ]
  float* thr_s;  // [TQ] the k-th key, -inf until the list is full
  int* thr_i;
  int* hit;      // [TQ] a score of this tile beats the k-th key (wgmma)
  float* ps;     // [kWarps][kTileN]
  int* pi;
};

// shared bytes of Lists after the score tile
__host__ __device__ constexpr size_t lists_bytes(int tq, int k, bool in_smem) {
  return 8ull * kWarps * kTileN + 16ull * tq +
         (in_smem ? 8ull * tq * k : 0ull);
}

__device__ __forceinline__ Lists lists_setup(uint8_t* p, int tq, int k,
                                             bool in_smem) {
  Lists l;
  l.ps = reinterpret_cast<float*>(p);
  l.pi = reinterpret_cast<int*>(l.ps + kWarps * kTileN);
  l.cnt = l.pi + kWarps * kTileN;
  l.thr_s = reinterpret_cast<float*>(l.cnt + tq);
  l.thr_i = reinterpret_cast<int*>(l.thr_s + tq);
  l.hit = l.thr_i + tq;
  l.ls = in_smem ? reinterpret_cast<float*>(l.hit + tq) : nullptr;
  l.li = in_smem ? reinterpret_cast<int*>(l.ls + tq * k) : nullptr;
  for (int i = threadIdx.x; i < tq; i += blockDim.x) {
    l.cnt[i] = 0;
    l.hit[i] = 0;
    l.thr_s[i] = -INFINITY;
    l.thr_i[i] = 0x7fffffff;
  }
  return l;
}

// Query qi's running list: shared, or its slot of the block's candidates
__device__ __forceinline__ void list_of(const Lists& l, int qi, int q0,
                                        int k, float* cand_s, int* cand_i,
                                        float*& ls, int*& li) {
  if (l.ls != nullptr) {
    ls = l.ls + static_cast<size_t>(qi) * k;
    li = l.li + static_cast<size_t>(qi) * k;
  } else {
    const size_t off =
        (static_cast<size_t>(q0 + qi) * gridDim.y + blockIdx.y) * k;
    ls = cand_s + off;
    li = cand_i + off;
  }
}

// One warp: filter and merge the row of the score tile `srow` (tile rows
// base ... base + 127, those at or past row_end excluded) into query qi's
// list.
__device__ __forceinline__ void select_row(const Lists& l, int qi, int q0,
                                           int k, const float* srow,
                                           int base, int row_end,
                                           float* cand_s, int* cand_i,
                                           int warp, int lane) {
  float s[kPer];
  int rows[kPer];
  bool ok[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int r = m * 32 + lane;
    s[m] = srow[r];
    rows[m] = base + r;
    ok[m] = base + r < row_end;
  }
  float* ls;
  int* li;
  list_of(l, qi, q0, k, cand_s, cand_i, ls, li);
  const int before = l.cnt[qi];
  const int cnt =
      filter_merge(ls, li, before, l.thr_s[qi], l.thr_i[qi],
                   l.ps + warp * kTileN, l.pi + warp * kTileN, s, rows, ok,
                   k, lane);
  if (lane == 0 && cnt != before) l.cnt[qi] = cnt;
  if (lane == 0 && cnt == k) {
    l.thr_s[qi] = ls[k - 1];
    l.thr_i[qi] = li[k - 1];
  }
  __syncwarp();
}

// Each query's sorted list to its slot of the candidates, (-inf, -1) past
// its count
__device__ __forceinline__ void write_lists(const Lists& l, int tq, int q0,
                                            int Q, int k, float* cand_s,
                                            int* cand_i, int warp,
                                            int lane) {
  for (int qi = warp; qi < tq; qi += kWarps) {
    if (q0 + qi >= Q) break;
    const int cnt = l.cnt[qi];
    const size_t off =
        (static_cast<size_t>(q0 + qi) * gridDim.y + blockIdx.y) * k;
    for (int i = lane; i < k; i += 32) {
      if (l.ls != nullptr && i < cnt) {
        cand_s[off + i] = l.ls[static_cast<size_t>(qi) * k + i];
        cand_i[off + i] = l.li[static_cast<size_t>(qi) * k + i];
      } else if (i >= cnt) {
        cand_s[off + i] = -INFINITY;
        cand_i[off + i] = -1;
      }
    }
  }
}

// f32: the SIMT product, 256 threads, grid (query tiles, row chunks)
template <int MQ>
__global__ void __launch_bounds__(kThreads, 1)
topk_tiles(const float* __restrict__ q, const float* __restrict__ e,
           const float* __restrict__ pen, int P, int Q, int N, int D, int k,
           int rows_per_block, int lists_in_smem, float* cand_s,
           int* cand_i) {
  constexpr int TQ = 16 * MQ;
  constexpr int kLdQ = TQ + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);       // [kChunk][kLdQ]
  float* es = qs + kChunk * kLdQ;                     // [kChunk][kLdE]
  float* sc = es + kChunk * kLdE;                     // [TQ][kLdS]
  const Lists l = lists_setup(reinterpret_cast<uint8_t*>(sc + TQ * kLdS), TQ,
                              k, lists_in_smem != 0);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * TQ;
  const int row_begin = blockIdx.y * rows_per_block;
  const int row_end = min(N, row_begin + rows_per_block);

  for (int base = row_begin; base < row_end; base += kTileN) {
    float acc[MQ][8];
    tile_product<float, MQ>(q, e, Q, N, D, q0, base, tid, qs, es, acc);

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
      select_row(l, qi, q0, k, sc + qi * kLdS, base, row_end, cand_s, cand_i,
                 warp, lane);
    }
    __syncthreads();
  }
  write_lists(l, TQ, q0, Q, k, cand_s, cand_i, warp, lane);
}

// shared bytes of the f32 pass 1
size_t simt_smem(int mq, int k, bool in_smem) {
  const int tq = 16 * mq;
  const size_t product = mq == 1 ? product_smem_floats<1>()
                                 : product_smem_floats<4>();
  return sizeof(float) * (product + static_cast<size_t>(tq) * kLdS) +
         lists_bytes(tq, k, in_smem);
}

// bf16: the wgmma product, 288 threads, grid (query tiles, row chunks)
template <int NQ>
__global__ void __launch_bounds__(kTmaThreads, 1)
topk_tiles_tc(const __grid_constant__ CUtensorMap map_e,
              const __grid_constant__ CUtensorMap map_q,
              const float* __restrict__ pen, int P, int Q, int N, int D,
              int k, int rows_per_block, int stages, int lists_in_smem,
              float* cand_s, int* cand_i) {
  extern __shared__ uint8_t smem_raw[];
  Ring ring;
  float* sc = reinterpret_cast<float*>(ring_setup(smem_raw, NQ, stages,
                                                  ring));  // [NQ][kLdT]
  const Lists l = lists_setup(reinterpret_cast<uint8_t*>(sc + NQ * kLdT), NQ,
                              k, lists_in_smem != 0);
  __syncthreads();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * NQ;
  const int row_begin = blockIdx.y * rows_per_block;
  const int row_end = min(N, row_begin + rows_per_block);
  const int n_slices = (D + kSliceD - 1) / kSliceD;
  uint32_t it = 0;

  PROBE_CLOCK(t_run);
  if (warp == kConsumerWarps) {  // the producer
    if (lane == 0) {
      for (int base = row_begin; base < row_end; base += kRowTile)
        produce_tile<NQ>(&map_e, &map_q, ring, n_slices, it, base, q0);
      PROBE_ADD(kProbeProducer, t_run);
    }
    return;
  }

  for (int base = row_begin; base < row_end; base += kRowTile) {
    float acc[NQ / 2];
    PROBE_CLOCK(t_main);
    consume_tile<NQ>(ring, n_slices, it, tid, acc);
    PROBE_ADD(kProbeMain, t_main);
    PROBE_CLOCK(t_epilogue);
    float add[2] = {0.f, 0.f};
    if (pen != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = base + frag_row(tid, 2 * h);
        add[h] = r < P ? pen[r] : kPastPenalty;
      }
    }
    consumer_sync();  // the last tile's selection is done with sc
    // scores to the tile; a query whose scores here all lose to its k-th
    // key is not selected at all (once the lists fill, nearly every query
    // of nearly every tile)
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) {
      if (i & 2) continue;  // handled with i - 2 (the same column)
      const int c = frag_col(tid, i);
      const float ts = l.thr_s[c];
      const int ti = l.thr_i[c];
      bool beats = false;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows r and r + 8 of column c
        const int r = frag_row(tid, i + 2 * h);
        const float s = pen != nullptr ? acc[i + 2 * h] + add[h]
                                       : acc[i + 2 * h];
        sc[c * kLdT + r] = s;
        beats |= base + r < row_end && better(s, base + r, ts, ti);
      }
      if (beats) l.hit[c] = 1;
    }
    consumer_sync();
    PROBE_ADD(kProbeEpilogue, t_epilogue);
    PROBE_CLOCK(t_select);
    for (int qi = warp; qi < NQ; qi += kWarps) {
      if (q0 + qi >= Q) break;
      if (!l.hit[qi]) continue;  // warp-uniform
      select_row(l, qi, q0, k, sc + qi * kLdT, base, row_end, cand_s, cand_i,
                 warp, lane);
      if (lane == 0) l.hit[qi] = 0;
    }
    PROBE_ADD(kProbeSelect, t_select);
  }
  PROBE_ADD(kProbeWarp, t_run);
  write_lists(l, NQ, q0, Q, k, cand_s, cand_i, warp, lane);
}

size_t tc_smem(int nq, int stages, int k, bool in_smem) {
  return ring_bytes(nq, stages) + sizeof(float) * nq * kLdT +
         lists_bytes(nq, k, in_smem);
}

// Pass 2: one warp a query over its S·k candidates (S blocks' lists); the
// running list in shared memory, or in the query's output row.
__global__ void __launch_bounds__(kThreads)
topk_merge(const float* __restrict__ cand_s, const int* __restrict__ cand_i,
           int m, int Q, int k, int list_in_smem, float* out_s, int* out_i) {
  extern __shared__ float4 smem4[];
  float* ps = reinterpret_cast<float*>(smem4);        // [kWarps][kTileN]
  int* pi = reinterpret_cast<int*>(ps + kWarps * kTileN);
  float* ls = reinterpret_cast<float*>(pi + kWarps * kTileN);  // [kWarps][k]
  int* li = reinterpret_cast<int*>(ls + kWarps * k);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qg = blockIdx.x * kWarps + warp;
  if (qg >= Q) return;  // whole warps leave; no block barrier follows
  float* wl = list_in_smem ? ls + static_cast<size_t>(warp) * k
                           : out_s + static_cast<size_t>(qg) * k;
  int* wi = list_in_smem ? li + static_cast<size_t>(warp) * k
                         : out_i + static_cast<size_t>(qg) * k;
  const float* cs = cand_s + static_cast<size_t>(qg) * m;
  const int* ci = cand_i + static_cast<size_t>(qg) * m;
  int cnt = 0;
  float ts = -INFINITY;
  int ti = 0x7fffffff;
  for (int base = 0; base < m; base += kTileN) {
    float s[kPer];
    int rows[kPer];
    bool ok[kPer];
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int j = base + t * 32 + lane;
      s[t] = j < m ? cs[j] : -INFINITY;
      rows[t] = j < m ? ci[j] : -1;
      ok[t] = rows[t] >= 0;
    }
    cnt = filter_merge(wl, wi, cnt, ts, ti, ps + warp * kTileN,
                       pi + warp * kTileN, s, rows, ok, k, lane);
    if (cnt == k) { ts = wl[k - 1]; ti = wi[k - 1]; }
  }
  for (int i = lane; i < k; i += 32) {
    const size_t o = static_cast<size_t>(qg) * k + i;
    if (i >= cnt) {
      out_s[o] = kNegInf;
      out_i[o] = -1;
    } else if (list_in_smem) {
      out_s[o] = wl[i];
      out_i[o] = wi[i];
    }
  }
}

size_t merge_smem(int k, bool in_smem) {
  return 8ull * kWarps * kTileN + (in_smem ? 8ull * kWarps * k : 0ull);
}

template <int MQ>
cudaError_t launch_simt(const void* q, const void* e, const float* pen, int P,
                        int Q, int N, int D, int k, int rpb, int S, int lsm,
                        float* cand_s, int* cand_i, cudaStream_t st) {
  constexpr int TQ = 16 * MQ;
  const size_t smem = simt_smem(MQ, k, lsm != 0);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      topk_tiles<MQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + TQ - 1) / TQ, S);
  topk_tiles<MQ><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(e), pen, P, Q,
      N, D, k, rpb, lsm, cand_s, cand_i);
  return cudaGetLastError();
}

template <int NQ>
cudaError_t launch_tc(const void* q, const void* e, const float* pen, int P,
                      int Q, int N, int D, int k, int rpb, int S, int stages,
                      int lsm, float* cand_s, int* cand_i, cudaStream_t st) {
  const size_t smem = tc_smem(NQ, stages, k, lsm != 0);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  CUtensorMap map_e, map_q;
  cudaError_t err = bf16_map(&map_e, e, N, D, kRowTile);
  if (err == cudaSuccess) err = bf16_map(&map_q, q, Q, D, NQ);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(topk_tiles_tc<NQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + NQ - 1) / NQ, S);
  topk_tiles_tc<NQ><<<grid, kTmaThreads, smem, st>>>(
      map_e, map_q, pen, P, Q, N, D, k, rpb, stages, lsm, cand_s, cand_i);
  return cudaGetLastError();
}

cudaError_t launch_pass1(int dtype, int tile_q, const void* q, const void* e,
                         const float* pen, int P, int Q, int N, int D, int k,
                         int rpb, int S, int stages, int lsm, float* cand_s,
                         int* cand_i, cudaStream_t st) {
  if (dtype == 0) {
    if (tile_q == 16)
      return launch_simt<1>(q, e, pen, P, Q, N, D, k, rpb, S, lsm, cand_s,
                            cand_i, st);
    return launch_simt<4>(q, e, pen, P, Q, N, D, k, rpb, S, lsm, cand_s,
                          cand_i, st);
  }
  switch (tile_q) {
    case 8:
      return launch_tc<8>(q, e, pen, P, Q, N, D, k, rpb, S, stages, lsm,
                          cand_s, cand_i, st);
    case 16:
      return launch_tc<16>(q, e, pen, P, Q, N, D, k, rpb, S, stages, lsm,
                           cand_s, cand_i, st);
    case 32:
      return launch_tc<32>(q, e, pen, P, Q, N, D, k, rpb, S, stages, lsm,
                           cand_s, cand_i, st);
    case 64:
      return launch_tc<64>(q, e, pen, P, Q, N, D, k, rpb, S, stages, lsm,
                           cand_s, cand_i, st);
    default:
      return launch_tc<128>(q, e, pen, P, Q, N, D, k, rpb, S, stages, lsm,
                            cand_s, cand_i, st);
  }
}

}  // namespace

extern "C" {

// dtype 0 = f32 (SIMT), 1 = bf16 (wgmma), q and e alike; q [Q, D], e [N, D],
// both contiguous and 16-byte aligned, D % 8 == 0; penalty [P] f32 or null;
// cand_* [Q, S, k] scratch with S = ceil(N / rows_per_block); out_* [Q, k].
// The launch plan (ops/topk.py::topk_plan) gives rows_per_block (a multiple
// of 128), tile_q (f32: 16 or 64; bf16: 8, 16, 32, 64 or 128), stages (the
// bf16 ring's depth, >= 3), whether pass 1 keeps its lists in shared memory
// and whether pass 2 does. Returns a cudaError_t.
int fused_topk(int dtype, const void* q, const void* e, const float* penalty,
               int P, int Q, int N, int D, int k, int rows_per_block,
               int tile_q, int stages, int lists_in_smem, int merge_in_smem,
               float* cand_s, int* cand_i, float* out_s, int* out_i,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q <= 0 || N <= 0 || D < 8 || D % 8 != 0 || k <= 0 ||
      rows_per_block <= 0 || rows_per_block % kTileN != 0 ||
      (dtype != 0 && dtype != 1) || (penalty != nullptr && P < 0) ||
      (dtype == 0 && tile_q != 16 && tile_q != 64) ||
      (dtype == 1 && (!tc_tile_ok(tile_q) || stages < 3)))
    return cudaErrorInvalidValue;
  const int S = (N + rows_per_block - 1) / rows_per_block;
  cudaError_t err = launch_pass1(dtype, tile_q, q, e, penalty, P, Q, N, D, k,
                                 rows_per_block, S, stages, lists_in_smem,
                                 cand_s, cand_i, st);
  if (err != cudaSuccess) return err;
  const size_t smem = merge_smem(k, merge_in_smem != 0);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(topk_merge,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  topk_merge<<<(Q + kWarps - 1) / kWarps, kThreads, smem, st>>>(
      cand_s, cand_i, S * k, Q, k, merge_in_smem, out_s, out_i);
  return cudaGetLastError();
}

// Shared bytes of a launch: pass 1 for (dtype, tile_q, stages, k, lists in
// shared memory), pass 2 for (k, its lists in shared memory).
// ops/topk.py::topk_plan computes the same on the CPU; the cuda tests hold
// it to these.
long long fused_topk_smem(int dtype, int tile_q, int stages, int k,
                          int lists_in_smem) {
  if (dtype == 0)
    return static_cast<long long>(
        simt_smem(tile_q == 16 ? 1 : 4, k, lists_in_smem != 0));
  return static_cast<long long>(
      tc_smem(tile_q, stages, k, lists_in_smem != 0));
}

long long fused_topk_merge_smem(int k, int in_smem) {
  return static_cast<long long>(merge_smem(k, in_smem != 0));
}

#ifdef TMA_PROBE
// The phase counters (tma_product.cuh) since the last call, summed over
// the blocks' rows into out[kProbeSlots]; then zeroed. Returns a
// cudaError_t.
int fused_topk_probe(unsigned long long* out) {
  static unsigned long long rows[kProbeRows][kProbeSlots];
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(rows, g_probe, sizeof(rows));
  if (err != cudaSuccess) return err;
  for (int s = 0; s < kProbeSlots; ++s) {
    out[s] = 0;
    for (int r = 0; r < kProbeRows; ++r) out[s] += rows[r][s];
  }
  memset(rows, 0, sizeof(rows));
  return cudaMemcpyToSymbol(g_probe, rows, sizeof(rows));
}
#endif

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
