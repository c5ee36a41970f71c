// Pooled-max int8 sweep for Hopper (sm_90a): bf16 queries against int8 rows
// with per-row scales, reduced to the max of every strided group of rows.
//
// Replaces the Pallas TPU kernel rag_dpo_tpu/ops/pooled.py::pooled_group_max
// (_pooled_max_kernel).
//
//   s[q, n] = (sum_d q[q, d] * e[n, d]) * scale[n] + pen[n]
//
// with pen 0 without a penalty and -5e29 for rows n >= P; rows n >= N score
// -1e30. Rows are cut into blocks of block_n; block j holds ng = block_n /
// group strided groups, group g being rows j·block_n + a·ng + g for a in
// [0, group). Out: per (query, block, group) the max as bf16 (rounded to
// nearest even) and the row of its first argmax (the lowest a, so the lowest
// row wins a tie), or -1 where the max is not above -5e29.
//
// The product is csrc/widen_product.cuh's: each int8 row element widened
// exactly to bf16 once a block, in the registers of the lane that
// multiplies it, against the bf16 queries (columns permuted by the wrapper
// to the lanes' k order) on the tensor cores as wgmma m64nNQk16, A from
// registers, f32 sums (every product exact; the sums in the tensor cores'
// order). This file is its epilogue: after a tile's products (one layer of
// 128 groups) each lane folds its cells into a running (max, first layer)
// kept in registers, the scale and the penalty applied with two roundings
// (no fused multiply-add), as the plain twin applies them; at an item's
// end it writes its cells. Any ng: groups past ng in a tile are products
// nobody writes.
//
// What bounds it on an H100: at 1M × 1024 rows the bytes (N·D int8 read
// once, 0.31 ms at 3.35 TB/s) up to Q ~ 150, then the bf16 products
// (2·Q·N·D at 989 TFLOP/s: 0.53 ms at Q 256). A block holds 16 or 64 queries; past
// 64 the query tiles of an item are neighbours in the grid and sweep its
// rows at about the same time, so the rows come from L2 after the first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "widen_product.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kPastPenalty = -5e29f;

template <int NQ>
struct PooledEpi {
  static constexpr bool kInt8Queries = false;
  const float* scale;
  const float* pen;
  int P, n_pool, lane_t;
  __nv_bfloat16* out_v;
  int* out_i;
  float vmax[NQ / 2];
  int amax[NQ / 2];
  float sc[2], add[2];  // the lane's two rows of the tile

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) { vmax[i] = -INFINITY; amax[i] = 0; }
  }

  // the scale and the added term of the lane's rows r0, r0 + 8: 0 and
  // -1e30 past N (so the row scores -1e30), else the row's scale and its
  // penalty (-5e29 past P, 0 without one); groups past ng are not written
  __device__ __forceinline__ void tile_start(const WidenArgs& w,
                                             const WidenCursor& cur, int r0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = cur.row(w, r0 + 8 * h);
      sc[h] = 0.f;
      add[h] = 0.f;
      if (row >= static_cast<size_t>(w.N)) {
        add[h] = kNegInf;
      } else {
        sc[h] = __ldg(scale + row);
        if (pen != nullptr)
          add[h] = row < static_cast<size_t>(P) ? __ldg(pen + row)
                                                : kPastPenalty;
      }
    }
  }

  __device__ __forceinline__ void fold(const float (&acc)[NQ / 2], int a) {
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) {
      const int h = (i >> 1) & 1;
      const float s = __fadd_rn(__fmul_rn(acc[i], sc[h]), add[h]);
      if (s > vmax[i]) { vmax[i] = s; amax[i] = a; }
    }
  }

  __device__ __forceinline__ void write(const WidenArgs& w,
                                        const WidenCursor& cur, int r0,
                                        int q0) {
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) {
      const int qg = q0 + acc_query(i, lane_t);
      const int g = cur.g0 + r0 + acc_row(i);
      if (qg >= w.Q || g >= w.ng) continue;
      const size_t off = static_cast<size_t>(qg) * n_pool +
                         static_cast<size_t>(cur.j) * w.ng + g;
      out_v[off] = __float2bfloat16_rn(vmax[i]);
      out_i[off] = vmax[i] > kPastPenalty
                       ? cur.j * w.block_n + amax[i] * w.ng + g
                       : -1;
    }
  }
};

template <int NQ>
__global__ void __launch_bounds__(kWThreads, 1)
pooled_max_kernel(const __grid_constant__ CUtensorMap map_e,
                  const __grid_constant__ CUtensorMap map_q, WidenArgs w,
                  const float* __restrict__ scale,
                  const float* __restrict__ pen, int P, int n_pool,
                  __nv_bfloat16* __restrict__ out_v, int* __restrict__ out_i) {
  PooledEpi<NQ> epi;
  epi.scale = scale;
  epi.pen = pen;
  epi.P = P;
  epi.n_pool = n_pool;
  epi.out_v = out_v;
  epi.out_i = out_i;
  epi.lane_t = threadIdx.x & 3;
  widen_sweep<NQ>(w, &map_e, &map_q, epi);
}

template <int NQ>
cudaError_t launch(const WidenArgs& w, const float* scale, const float* pen,
                   int P, int n_pool, void* out_v, int* out_i,
                   cudaStream_t st) {
  CUtensorMap map_e, map_q;
  const int dq = (w.D + 63) / 64 * 64;  // the permuted queries' columns
  cudaError_t err = int8_rows_map(&map_e, w.e, w.N, w.D);
  if (err == cudaSuccess) err = bf16_map(&map_q, w.q, w.Q, dq, NQ);
  if (err != cudaSuccess) return err;
  const int smem =
      widen_smem(NQ, w.stages, false, (w.D + kWChunk - 1) / kWChunk);
  err = cudaFuncSetAttribute(pooled_max_kernel<NQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  pooled_max_kernel<NQ><<<w.walkers * w.qtiles, kWThreads, smem, st>>>(
      map_e, map_q, w, scale, pen, P, n_pool,
      static_cast<__nv_bfloat16*>(out_v), out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [Q, Dq] bf16 with Dq = D rounded up to 64, its columns in query_col
// order (ops/widen_product.py's `permute_columns`), e [N, D] int8, scale
// [N] f32, penalty [P] f32 or null, all contiguous and 16-byte aligned;
// out_v [Q, nb·ng] bf16 and out_i [Q, nb·ng] int32 with nb = ceil(N /
// block_n), ng = block_n / group. Needs D % 16 == 0 and block_n % group ==
// 0. The plan (nq queries a block, stages) is ops/widen_product.py's
// `widen_plan`. Returns a cudaError_t.
int pooled_max(const void* q, const int8_t* e, const float* scale,
               const float* penalty, int P, int Q, int N, int D, int block_n,
               int group, int nq, int stages, void* out_v, int* out_i,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (D + kWChunk - 1) / kWChunk;
  if (Q <= 0 || N <= 0 || D < 16 || D % 16 != 0 || group <= 0 ||
      block_n <= 0 || block_n % group != 0 || (penalty != nullptr && P < 0) ||
      !widen_plan_ok(nq, stages, false, chunks))
    return cudaErrorInvalidValue;
  WidenArgs w;
  w.q = q;
  w.e = e;
  w.Q = Q;
  w.N = N;
  w.D = D;
  w.block_n = block_n;
  w.group = group;
  w.ng = block_n / group;
  const int nb = (N + block_n - 1) / block_n;
  w.n_gchunks = (w.ng + kWTileRows - 1) / kWTileRows;
  w.n_items = nb * w.n_gchunks;
  w.qtiles = (Q + nq - 1) / nq;
  w.walkers = widen_walkers(w.n_items, w.qtiles);
  w.stages = stages;
  const int n_pool = nb * w.ng;
  if (nq == 16)
    return launch<16>(w, scale, penalty, P, n_pool, out_v, out_i, st);
  return launch<64>(w, scale, penalty, P, n_pool, out_v, out_i, st);
}

// the plan's dynamic shared bytes, as the launch asks for them
int widen_sweep_smem(int nq, int stages, int resident, int chunks) {
  return widen_smem(nq, stages, resident != 0, chunks);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
