// The SIMT f32 product of a query tile with a 128-row tile of embeddings,
// shared by the dense selectors csrc/fused_topk.cu (K4) and
// csrc/seg_candidates.cu (K5) for f32 inputs: the scale phase's exact
// oracle and any store kept in f32. TF32 tensor cores would keep about three
// decimal digits, which ROADMAP C-5 gives up nowhere; bf16 inputs take the
// tensor-core product of csrc/tma_product.cuh instead.
//
// 256 threads; thread (tx = tid & 15, ty = tid >> 4) holds the sums of
// queries q0 + ty*MQ + i (i < MQ) with rows base + tile_col(tx, j) (j < 8).
// D goes in 32-wide slices staged through shared memory as f32, the next
// slice loaded into registers while the current one is multiplied. Each sum
// starts at +0 and adds its products in d order with f32 fused
// multiply-adds, so no sum is -0. Rows past N and queries past Q read as
// zeros; D needs no upper limit (any multiple of 8).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 128;           // rows per tile
constexpr int kChunk = 32;            // D per shared-memory slice
constexpr int kLdE = kTileN + 4;      // padded row of the transposed slice
constexpr int kEUnits = kTileN * (kChunk / 8) / kThreads;  // 8-row loads

// f32 entries of shared memory the product stages through: the query slice
// [kChunk][TQ + 4], then the row slice [kChunk][kLdE]
template <int MQ>
constexpr int product_smem_floats() {
  return kChunk * (16 * MQ + 4) + kChunk * kLdE;
}

// the tile column of a thread's j-th sum
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
}

// 8 consecutive f32 elements, two 16-byte loads
__device__ __forceinline__ void load8(const float* p, bool ok, float* out) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  if (ok) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// The next D slice of the row tile and the query tile, into registers:
// kEUnits 8-element loads of rows per thread, one of queries for the first
// TQ·4 threads; zeros past N, Q and D.
template <typename T, int MQ>
__device__ __forceinline__ void load_slice(
    const T* __restrict__ q, const T* __restrict__ e, int Q, int N, int D,
    int q0, int base, int c, int tid, float (&ev)[kEUnits][8],
    float (&qv)[8]) {
#pragma unroll
  for (int u = 0; u < kEUnits; ++u) {
    const int id = tid + kThreads * u;
    const int r = id >> 2, d = c * kChunk + (id & 3) * 8;
    const bool ok = base + r < N && d < D;
    load8(e + static_cast<size_t>(ok ? base + r : 0) * D + (ok ? d : 0), ok,
          ev[u]);
  }
  if (tid < 16 * MQ * (kChunk / 8)) {
    const int r = tid >> 2, d = c * kChunk + (tid & 3) * 8;
    const bool ok = q0 + r < Q && d < D;
    load8(q + static_cast<size_t>(ok ? q0 + r : 0) * D + (ok ? d : 0), ok,
          qv);
  }
}

// acc[i][j] = q[q0 + ty*MQ + i] · e[base + tile_col(tx, j)]. Every thread of
// the block calls it (it holds block barriers); qs and es point at the shared
// memory of product_smem_floats<MQ>(), free again when it returns.
template <typename T, int MQ>
__device__ __forceinline__ void tile_product(
    const T* __restrict__ q, const T* __restrict__ e, int Q, int N, int D,
    int q0, int base, int tid, float* qs, float* es, float (&acc)[MQ][8]) {
  constexpr int TQ = 16 * MQ;
  constexpr int kLdQ = TQ + 4;
  constexpr int kQUnits = TQ * (kChunk / 8);  // 8-element query loads
  const int tx = tid & 15, ty = tid >> 4;
  const int n_chunks = (D + kChunk - 1) / kChunk;
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float ev[kEUnits][8], qv[8];
  load_slice<T, MQ>(q, e, Q, N, D, q0, base, 0, tid, ev, qv);
  for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
    for (int u = 0; u < kEUnits; ++u) {
      const int id = tid + kThreads * u;
      const int r = id >> 2, d0 = (id & 3) * 8;
#pragma unroll
      for (int x = 0; x < 8; ++x) es[(d0 + x) * kLdE + r] = ev[u][x];
    }
    if (tid < kQUnits) {
      const int r = tid >> 2, d0 = (tid & 3) * 8;
#pragma unroll
      for (int x = 0; x < 8; ++x) qs[(d0 + x) * kLdQ + r] = qv[x];
    }
    __syncthreads();
    if (c + 1 < n_chunks)
      load_slice<T, MQ>(q, e, Q, N, D, q0, base, c + 1, tid, ev, qv);
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[MQ], b[8];
      if constexpr (MQ == 4) {
        const float4 t =
            *reinterpret_cast<const float4*>(qs + kk * kLdQ + ty * 4);
        a[0] = t.x; a[1] = t.y; a[2] = t.z; a[3] = t.w;
      } else {
        a[0] = qs[kk * kLdQ + ty];
      }
      const float4 b0 =
          *reinterpret_cast<const float4*>(es + kk * kLdE + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(es + kk * kLdE + 64 + tx * 4);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace
