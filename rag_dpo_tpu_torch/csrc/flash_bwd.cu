// Flash-attention backward for Hopper (sm_90a): dq, and dk with dv, of the
// length-masked non-causal attention that flash_fwd.cu computes.
//
// Replaces the Pallas TPU kernels
//   rag_dpo_tpu/ops/flash_attention_bwd.py::_dq_kernel   (flash_bwd_dq)
//   rag_dpo_tpu/ops/flash_attention_bwd.py::_dkv_kernel  (flash_bwd_dkv)
// and keeps their math (the FlashAttention-2 backward), all in f32 whatever
// the input type:
//   P  = exp(S * scale - lse)  where key < length, else 0
//   dS = P * (dO . V^T - D)    with D = rowsum(dO * O), given by the caller
//   dQ = scale * dS . K        zeroed on query rows >= length
//   dK = scale * dS^T . Q,  dV = P^T . dO   over query rows < length only
//
// Layout: q, k, v, dout and the gradients are [B, H, S, Dh] contiguous;
// lengths [B] int32; lse and D [B, H, S] f32. One block of 4·R threads owns
// one (b*h, R-row tile): a query tile for dq, a key tile for dk/dv. It
// keeps its own tile and its f32 accumulators on chip and loops over the
// other side's R-row tiles below min(lengths[b], S); thread t owns row t/4
// of its tile and the columns (t%4) + 4*j. R is 64 for DH up to 128, 32 at
// 256 and 16 at 512, so four tiles fit in shared memory. Tiles that hold
// only rows at or past the length are skipped: their P is 0. The ragged
// edge of S is masked in the kernel; nothing is padded in memory. DH is one
// of 16, 32, 64, 128, 256 and 512: the wrapper pads other widths with zero
// columns, which add exact zeros to every sum.
//
// What bounds it on an H100: the products run on the CUDA cores in full f32
// (no tensor cores; flash_fwd.cu's split onto them is the next step), one
// shared-memory operand per FMA. dq does three RxRxDh products per tile
// pair (S, dO.V^T, dS.K), dk/dv four (S^T, V.dO^T, P^T.dO, dS^T.Q), with the
// S and dO.V^T products recomputed by both kernels instead of kept in device
// memory. Rows in shared memory are padded by one word so the eight rows a
// warp reads at once fall in distinct banks. At DH 256 and 512 the
// accumulators spill (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// rows of a tile, on both sides; the block has 4 threads per row of its own
// tile and each thread kBlock / 4 entries of a score row
template <int DH>
__host__ __device__ constexpr int block_rows() {
  return DH <= 128 ? 64 : DH <= 256 ? 32 : 16;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like astype
}

// rows [row0, row0 + kBlock) of a [S, DH] matrix into a padded f32 tile;
// rows at or past S read as 0
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int S) {
  constexpr int kBlock = block_rows<DH>(), kThreads = 4 * kBlock;
  for (int e = threadIdx.x; e < kBlock * DH; e += kThreads) {
    const int rr = e / DH, d = e % DH, row = row0 + rr;
    dst[rr * (DH + 1) + d] =
        row < S ? to_f32(src[static_cast<size_t>(row) * DH + d]) : 0.f;
  }
}

template <int DH>
constexpr size_t dq_smem_bytes() {
  constexpr size_t kBlock = block_rows<DH>();
  return sizeof(float) * (4 * kBlock * (DH + 1) + kBlock * (kBlock + 1));
}

template <int DH>
constexpr size_t dkv_smem_bytes() {
  constexpr size_t kBlock = block_rows<DH>();
  return sizeof(float) *
         (4 * kBlock * (DH + 1) + 2 * kBlock * (kBlock + 1) + 2 * kBlock);
}

template <typename T, int DH>
__global__ void __launch_bounds__(4 * block_rows<DH>())
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const int* __restrict__ lengths,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, T* __restrict__ dq, int H,
                    int S, int n_qtiles, float scale) {
  constexpr int kBlock = block_rows<DH>(), kScores = kBlock / 4;
  extern __shared__ float smem[];
  float* qs = smem;                     // [kBlock][DH + 1]
  float* dos = qs + kBlock * (DH + 1);  // [kBlock][DH + 1]
  float* ks = dos + kBlock * (DH + 1);  // [kBlock][DH + 1]
  float* vs = ks + kBlock * (DH + 1);   // [kBlock][DH + 1]
  float* dss = vs + kBlock * (DH + 1);  // [kBlock][kBlock + 1]

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlock;
  const int b = bh / H;
  const size_t base = static_cast<size_t>(bh) * S * DH;
  const int r = threadIdx.x >> 2;
  const int c = threadIdx.x & 3;
  const int row = q0 + r;
  const int len = max(0, min(lengths[b], S));

  constexpr int kCols = DH / 4;
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  // dq is 0 on rows at or past the length, so such a tile does no work
  const int n_ktiles = q0 < len ? (len + kBlock - 1) / kBlock : 0;
  float row_lse = 0.f, row_dd = 0.f;
  if (n_ktiles > 0) {
    load_tile<T, DH>(qs, q + base, q0, S);
    load_tile<T, DH>(dos, dout + base, q0, S);
    if (row < S) {
      row_lse = lse[static_cast<size_t>(bh) * S + row];
      row_dd = dd[static_cast<size_t>(bh) * S + row];
    }
  }
  const float* qrow = qs + r * (DH + 1);
  const float* dorow = dos + r * (DH + 1);
  for (int t = 0; t < n_ktiles; ++t) {
    const int k0 = t * kBlock;
    __syncthreads();  // the previous tile's ks/vs/dss are no longer read
    load_tile<T, DH>(ks, k + base, k0, S);
    load_tile<T, DH>(vs, v + base, k0, S);
    __syncthreads();

    float s[kScores], dp[kScores];
#pragma unroll
    for (int j = 0; j < kScores; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float qv = qrow[d], gv = dorow[d];
#pragma unroll
      for (int j = 0; j < kScores; ++j) {
        const int off = (c + 4 * j) * (DH + 1) + d;
        s[j] = fmaf(qv, ks[off], s[j]);
        dp[j] = fmaf(gv, vs[off], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kScores; ++j) {
      const int col = k0 + c + 4 * j;
      const float p = col < len ? expf(s[j] * scale - row_lse) : 0.f;
      dss[r * (kBlock + 1) + c + 4 * j] = p * (dp[j] - row_dd);
    }
    __syncthreads();

    const float* dsrow = dss + r * (kBlock + 1);
#pragma unroll 4
    for (int kk = 0; kk < kBlock; ++kk) {
      const float ds = dsrow[kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[j] = fmaf(ds, ks[kk * (DH + 1) + c + 4 * j], acc[j]);
    }
  }

  if (row < S) {
    T* out = dq + base + static_cast<size_t>(row) * DH;
    const bool live = row < len;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      out[c + 4 * j] = from_f32<T>(live ? acc[j] * scale : 0.f);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(4 * block_rows<DH>())
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const int* __restrict__ lengths,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int S, int n_ktiles,
                     float scale) {
  constexpr int kBlock = block_rows<DH>(), kScores = kBlock / 4;
  extern __shared__ float smem[];
  float* ks = smem;                     // [kBlock][DH + 1]
  float* vs = ks + kBlock * (DH + 1);   // [kBlock][DH + 1]
  float* qs = vs + kBlock * (DH + 1);   // [kBlock][DH + 1]
  float* dos = qs + kBlock * (DH + 1);  // [kBlock][DH + 1]
  float* pst = dos + kBlock * (DH + 1);   // P^T  [kBlock][kBlock + 1]
  float* dst = pst + kBlock * (kBlock + 1);  // dS^T [kBlock][kBlock + 1]
  float* lses = dst + kBlock * (kBlock + 1);  // [kBlock]
  float* dds = lses + kBlock;                 // [kBlock]

  const int bh = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x % n_ktiles) * kBlock;
  const int b = bh / H;
  const size_t base = static_cast<size_t>(bh) * S * DH;
  const int r = threadIdx.x >> 2;
  const int c = threadIdx.x & 3;
  const int key = k0 + r;
  const int len = max(0, min(lengths[b], S));

  constexpr int kCols = DH / 4;
  float dk_acc[kCols], dv_acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  // keys at or past the length get P = 0 from every query: dk = dv = 0
  const int n_qtiles = k0 < len ? (len + kBlock - 1) / kBlock : 0;
  if (n_qtiles > 0) {
    load_tile<T, DH>(ks, k + base, k0, S);
    load_tile<T, DH>(vs, v + base, k0, S);
  }
  const float* krow = ks + r * (DH + 1);
  const float* vrow = vs + r * (DH + 1);
  const bool key_live = key < len;
  for (int i = 0; i < n_qtiles; ++i) {
    const int q0 = i * kBlock;
    __syncthreads();  // the previous tile's qs/dos/pst/dst are no longer read
    load_tile<T, DH>(qs, q + base, q0, S);
    load_tile<T, DH>(dos, dout + base, q0, S);
    if (threadIdx.x < kBlock) {
      const int qrow = q0 + threadIdx.x;
      const bool live = qrow < len;
      lses[threadIdx.x] = live ? lse[static_cast<size_t>(bh) * S + qrow] : 0.f;
      dds[threadIdx.x] = live ? dd[static_cast<size_t>(bh) * S + qrow] : 0.f;
    }
    __syncthreads();

    float s[kScores], dp[kScores];
#pragma unroll
    for (int j = 0; j < kScores; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float kv = krow[d], vv = vrow[d];
#pragma unroll
      for (int j = 0; j < kScores; ++j) {
        const int off = (c + 4 * j) * (DH + 1) + d;
        s[j] = fmaf(kv, qs[off], s[j]);
        dp[j] = fmaf(vv, dos[off], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kScores; ++j) {
      const int qq = c + 4 * j;
      const bool live = key_live && q0 + qq < len;
      const float p = live ? expf(s[j] * scale - lses[qq]) : 0.f;
      pst[r * (kBlock + 1) + qq] = p;
      dst[r * (kBlock + 1) + qq] = p * (dp[j] - dds[qq]);
    }
    __syncthreads();

    const float* prow = pst + r * (kBlock + 1);
    const float* dsrow = dst + r * (kBlock + 1);
#pragma unroll 4
    for (int qq = 0; qq < kBlock; ++qq) {
      const float p = prow[qq], ds = dsrow[qq];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int off = qq * (DH + 1) + c + 4 * j;
        dv_acc[j] = fmaf(p, dos[off], dv_acc[j]);
        dk_acc[j] = fmaf(ds, qs[off], dk_acc[j]);
      }
    }
  }

  if (key < S) {
    const size_t off = base + static_cast<size_t>(key) * DH;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dk[off + c + 4 * j] = from_f32<T>(dk_acc[j] * scale);
      dv[off + c + 4 * j] = from_f32<T>(dv_acc[j]);
    }
  }
}

template <typename T, int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const int* lengths, const float* lse,
                      const float* dd, void* dq, int B, int H, int S,
                      float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DH>();
  auto kernel = flash_bwd_dq_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int kBlock = block_rows<DH>();
  const int n_qtiles = (S + kBlock - 1) / kBlock;
  const long long n_blocks = static_cast<long long>(n_qtiles) * B * H;
  if (n_blocks == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(n_blocks), 4 * kBlock, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lengths, lse, dd,
      static_cast<T*>(dq), H, S, n_qtiles, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const int* lengths, const float* lse,
                       const float* dd, void* dk, void* dv, int B, int H,
                       int S, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DH>();
  auto kernel = flash_bwd_dkv_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int kBlock = block_rows<DH>();
  const int n_ktiles = (S + kBlock - 1) / kBlock;
  const long long n_blocks = static_cast<long long>(n_ktiles) * B * H;
  if (n_blocks == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(n_blocks), 4 * kBlock, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lengths, lse, dd,
      static_cast<T*>(dk), static_cast<T*>(dv), H, S, n_ktiles, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v,
                        const void* dout, const int* lengths,
                        const float* lse, const float* dd, void* dq, int B,
                        int H, int S, int Dh, float scale,
                        cudaStream_t st) {
  switch (Dh) {
    case 16: return launch_dq<T, 16>(q, k, v, dout, lengths, lse, dd, dq, B, H, S, scale, st);
    case 32: return launch_dq<T, 32>(q, k, v, dout, lengths, lse, dd, dq, B, H, S, scale, st);
    case 64: return launch_dq<T, 64>(q, k, v, dout, lengths, lse, dd, dq, B, H, S, scale, st);
    case 128: return launch_dq<T, 128>(q, k, v, dout, lengths, lse, dd, dq, B, H, S, scale, st);
    case 256: return launch_dq<T, 256>(q, k, v, dout, lengths, lse, dd, dq, B, H, S, scale, st);
    case 512: return launch_dq<T, 512>(q, k, v, dout, lengths, lse, dd, dq, B, H, S, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const int* lengths,
                         const float* lse, const float* dd, void* dk,
                         void* dv, int B, int H, int S, int Dh, float scale,
                         cudaStream_t st) {
  switch (Dh) {
    case 16: return launch_dkv<T, 16>(q, k, v, dout, lengths, lse, dd, dk, dv, B, H, S, scale, st);
    case 32: return launch_dkv<T, 32>(q, k, v, dout, lengths, lse, dd, dk, dv, B, H, S, scale, st);
    case 64: return launch_dkv<T, 64>(q, k, v, dout, lengths, lse, dd, dk, dv, B, H, S, scale, st);
    case 128: return launch_dkv<T, 128>(q, k, v, dout, lengths, lse, dd, dk, dv, B, H, S, scale, st);
    case 256: return launch_dkv<T, 256>(q, k, v, dout, lengths, lse, dd, dk, dv, B, H, S, scale, st);
    case 512: return launch_dkv<T, 512>(q, k, v, dout, lengths, lse, dd, dk, dv, B, H, S, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dq). Returns a cudaError_t.
int flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                 const void* dout, const int* lengths, const float* lse,
                 const float* dd, void* dq, int B, int H, int S, int Dh,
                 float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dq<float>(q, k, v, dout, lengths, lse, dd, dq, B, H, S,
                              Dh, scale, st);
  if (dtype == 1)
    return dispatch_dq<__nv_bfloat16>(q, k, v, dout, lengths, lse, dd, dq, B,
                                      H, S, Dh, scale, st);
  return cudaErrorInvalidValue;
}

// dtype as above (q, k, v, dout, dk, dv). Returns a cudaError_t.
int flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                  const void* dout, const int* lengths, const float* lse,
                  const float* dd, void* dk, void* dv, int B, int H, int S,
                  int Dh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dkv<float>(q, k, v, dout, lengths, lse, dd, dk, dv, B, H,
                               S, Dh, scale, st);
  if (dtype == 1)
    return dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lengths, lse, dd, dk,
                                       dv, B, H, S, Dh, scale, st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
