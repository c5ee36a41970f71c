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
// q is bf16 and e int8: both widen to f32 exactly and each product is exact,
// so only the sum rounds (in d order, f32 fused multiply-adds per thread).
// The scale and the penalty apply with two roundings (no fused
// multiply-add), as the plain twin applies them.
//
// Grid (blocks × 128-group chunks, query tiles), 256 threads. Layer a of a
// block's groups is 128 consecutive rows, so a block walks a = 0..group-1
// and each thread keeps a running (max, a) for its 1x8 or 4x8 (query, group)
// cells in registers: no score ever reaches memory. Each layer is a SIMT
// product of the query tile with 128 rows, D in 64-wide slices staged
// through shared memory as f32, the next slice loaded into registers while
// the current one is multiplied; the slices loop over any D % 16 == 0.
//
// What bounds it on an H100: the products, 2·Q·N·D flops on the CUDA cores
// in f32 (67 TFLOP/s), against N·D int8 bytes read once (3.35 TB/s): the
// operations bound it from Q ~ 5 up. The int8 tensor-core rate (1,979
// TOP/s) needs int8 queries and is not this function; bf16 wgmma is for a
// later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 128;            // rows per layer tile
constexpr int kChunk = 64;             // D per shared-memory slice
constexpr int kLdE = kTileN + 4;
constexpr int kEUnits = kTileN * (kChunk / 16) / kThreads;  // 16 int8 each
constexpr float kNegInf = -1e30f;
constexpr float kPastPenalty = -5e29f;

__device__ __forceinline__ void load_i8x16(const int8_t* p, bool ok,
                                           float* out) {
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (ok) u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)  // byte b of word i is element 4i + b
      out[4 * i + b] = static_cast<float>(
          static_cast<int8_t>((w[i] >> (8 * b)) & 0xffu));
}

__device__ __forceinline__ void load_bf16x8(const __nv_bfloat16* p, bool ok,
                                            float* out) {
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (ok) u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 is the high half of an f32
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Slice c of layer rows (row0 + col for col in [0, 128), cols at or past
// n_cols empty) and of the query tile, into registers; zeros past N, Q, D.
template <int MQ>
__device__ __forceinline__ void load_slice(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ e, int Q,
    int N, int D, int q0, int row0, int n_cols, int c, int tid,
    float (&ev)[kEUnits][16], float (&qv)[2][8]) {
#pragma unroll
  for (int u = 0; u < kEUnits; ++u) {
    const int id = tid + kThreads * u;
    const int col = id >> 2, d = c * kChunk + (id & 3) * 16;
    const int row = row0 + col;
    const bool ok = col < n_cols && row < N && d < D;
    load_i8x16(e + static_cast<size_t>(ok ? row : 0) * D + (ok ? d : 0), ok,
               ev[u]);
  }
  constexpr int kQUnits = 16 * MQ * (kChunk / 8);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int id = tid + kThreads * u;
    if (id < kQUnits) {
      const int r = id >> 3, d = c * kChunk + (id & 7) * 8;
      const bool ok = q0 + r < Q && d < D;
      load_bf16x8(q + static_cast<size_t>(ok ? q0 + r : 0) * D + (ok ? d : 0),
                  ok, qv[u]);
    }
  }
}

template <int MQ>
__global__ void __launch_bounds__(kThreads, 2)
pooled_max_kernel(const __nv_bfloat16* __restrict__ q,
                  const int8_t* __restrict__ e,
                  const float* __restrict__ scale,
                  const float* __restrict__ pen, int P, int Q, int N, int D,
                  int block_n, int group, int n_pool,
                  __nv_bfloat16* __restrict__ out_v,
                  int* __restrict__ out_i) {
  constexpr int TQ = 16 * MQ;
  constexpr int kLdQ = TQ + 4;
  constexpr int kQUnits = TQ * (kChunk / 8);
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kChunk][kLdQ]
  float* es = qs + kChunk * kLdQ;                // [kChunk][kLdE]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ng = block_n / group;
  const int n_gchunks = (ng + kTileN - 1) / kTileN;
  const int blk = blockIdx.x / n_gchunks;
  const int g0 = (blockIdx.x % n_gchunks) * kTileN;
  const int n_cols = min(kTileN, ng - g0);
  const int base = blk * block_n;
  const int q0 = blockIdx.y * TQ;
  const int n_chunks = (D + kChunk - 1) / kChunk;

  float vmax[MQ][8];
  int amax[MQ][8];
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) { vmax[i][j] = -INFINITY; amax[i][j] = 0; }

  for (int a = 0; a < group; ++a) {
    const int row0 = base + a * ng + g0;
    float acc[MQ][8];
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float ev[kEUnits][16], qv[2][8];
    load_slice<MQ>(q, e, Q, N, D, q0, row0, n_cols, 0, tid, ev, qv);
    for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
      for (int u = 0; u < kEUnits; ++u) {
        const int id = tid + kThreads * u;
        const int col = id >> 2, d0 = (id & 3) * 16;
#pragma unroll
        for (int x = 0; x < 16; ++x) es[(d0 + x) * kLdE + col] = ev[u][x];
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int id = tid + kThreads * u;
        if (id < kQUnits) {
          const int r = id >> 3, d0 = (id & 7) * 8;
#pragma unroll
          for (int x = 0; x < 8; ++x) qs[(d0 + x) * kLdQ + r] = qv[u][x];
        }
      }
      __syncthreads();
      if (c + 1 < n_chunks)
        load_slice<MQ>(q, e, Q, N, D, q0, row0, n_cols, c + 1, tid, ev, qv);
#pragma unroll 8
      for (int kk = 0; kk < kChunk; ++kk) {
        float av[MQ], b[8];
        if constexpr (MQ == 4) {
          const float4 t = *reinterpret_cast<const float4*>(
              qs + kk * kLdQ + ty * 4);
          av[0] = t.x; av[1] = t.y; av[2] = t.z; av[3] = t.w;
        } else {
          av[0] = qs[kk * kLdQ + ty];
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
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    // group cells col = tx*4 + j and 64 + tx*4 + j of this layer
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
      const int row = row0 + col;
      const bool live = col < n_cols && row < N;
      float sc = 0.f, add = 0.f;
      if (live) {
        sc = scale[row];
        if (pen != nullptr) add = row < P ? pen[row] : kPastPenalty;
      }
#pragma unroll
      for (int i = 0; i < MQ; ++i) {
        const float s =
            live ? __fadd_rn(__fmul_rn(acc[i][j], sc), add) : kNegInf;
        if (s > vmax[i][j]) { vmax[i][j] = s; amax[i][j] = a; }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
    if (col >= n_cols) continue;
    const int g = g0 + col;
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      const int qg = q0 + ty * MQ + i;
      if (qg >= Q) continue;
      const size_t off = static_cast<size_t>(qg) * n_pool + blk * ng + g;
      out_v[off] = __float2bfloat16_rn(vmax[i][j]);
      out_i[off] = vmax[i][j] > kPastPenalty ? base + amax[i][j] * ng + g : -1;
    }
  }
}

template <int MQ>
cudaError_t launch(const void* q, const int8_t* e, const float* scale,
                   const float* pen, int P, int Q, int N, int D, int block_n,
                   int group, void* out_v, int* out_i, cudaStream_t st) {
  constexpr int TQ = 16 * MQ;
  const size_t smem = sizeof(float) * (kChunk * (TQ + 4) + kChunk * kLdE);
  cudaError_t err = cudaFuncSetAttribute(
      pooled_max_kernel<MQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nb = (N + block_n - 1) / block_n;
  const int ng = block_n / group;
  const dim3 grid(nb * ((ng + kTileN - 1) / kTileN), (Q + TQ - 1) / TQ);
  pooled_max_kernel<MQ><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), e, scale, pen, P, Q, N, D,
      block_n, group, nb * ng, static_cast<__nv_bfloat16*>(out_v), out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [Q, D] bf16, e [N, D] int8, scale [N] f32, penalty [P] f32 or null, all
// contiguous and 16-byte aligned; out_v [Q, nb·ng] bf16 and out_i [Q, nb·ng]
// int32 with nb = ceil(N / block_n), ng = block_n / group. Needs
// D % 16 == 0 (any D: the slices loop over it) and block_n % group == 0.
// Returns a cudaError_t.
int pooled_max(const void* q, const int8_t* e, const float* scale,
               const float* penalty, int P, int Q, int N, int D, int block_n,
               int group, void* out_v, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q <= 0 || N <= 0 || D < 16 || D % 16 != 0 || group <= 0 ||
      block_n <= 0 || block_n % group != 0 || (penalty != nullptr && P < 0))
    return cudaErrorInvalidValue;
  if (Q <= 16)
    return launch<1>(q, e, scale, penalty, P, Q, N, D, block_n, group, out_v,
                     out_i, st);
  return launch<4>(q, e, scale, penalty, P, Q, N, D, block_n, group, out_v,
                   out_i, st);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
