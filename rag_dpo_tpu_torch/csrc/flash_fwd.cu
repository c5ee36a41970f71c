// Flash-attention forward for Hopper (sm_90a): non-causal attention with keys
// masked by a per-batch length, online softmax in f32, optional logsumexp.
//
// Replaces the Pallas TPU kernels
//   rag_dpo_tpu/ops/flash_attention_bwd.py::_fwd_kernel (via _fwd_with_stats)
//   rag_dpo_tpu/ops/flash_attention.py::_flash_kernel (same math, no lse)
// and keeps their numerics: scores and accumulators in f32 whatever the input
// type, running max clamped at -1e20 and the denominator at 1e-30, so a row
// whose keys are all masked outputs 0 and lse = -1e20.
//
// Layout: q, k, v, out are [B, H, S, Dh] contiguous; lengths [B] int32; lse
// [B, H, S] f32 (the wrapper views it as [B, H, S, 1]). One block of 256
// threads owns one (b*h, 64-row query tile) and loops over 64-row key tiles
// held in shared memory; thread t owns query row t/4 and the output columns
// (t%4) + 4*j, so the four threads of a row reduce its max and sum with two
// warp shuffles. Key tiles at or past min(lengths[b], S) are skipped: they
// would contribute exp(-1e30 - m) = 0 and leave the running max unchanged.
// The ragged edge of S is masked in the kernel; nothing is padded in memory.
//
// What bounds it on an H100: the two tile products run on the CUDA cores in
// full f32 (no tensor cores, so f32 inputs keep f32 accuracy) and read one
// shared-memory operand per FMA, which caps it near a quarter of the f32 FMA
// rate. Shared-memory rows are padded by one word so the eight query rows a
// warp reads at once fall in distinct banks. Moving the products to wgmma
// with bf16 P is later work (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 4 threads per query row
constexpr float kNegInf = -1e30f;

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

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * (DH + 1) + kBlockK * (DH + 1) +
                          kBlockK * DH + kBlockQ * (kBlockK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 T* __restrict__ out, float* __restrict__ lse, int H, int S,
                 int n_qtiles, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                       // [kBlockQ][DH + 1]
  float* ks = qs + kBlockQ * (DH + 1);    // [kBlockK][DH + 1]
  float* vs = ks + kBlockK * (DH + 1);    // [kBlockK][DH]
  float* ps = vs + kBlockK * DH;          // [kBlockQ][kBlockK + 1]

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlockQ;
  const int b = bh / H;
  const size_t base = static_cast<size_t>(bh) * S * DH;
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int c = tid & 3;
  const int len = max(0, min(lengths[b], S));

  for (int e = tid; e < kBlockQ * DH; e += kThreads) {
    const int rr = e / DH, d = e % DH, row = q0 + rr;
    qs[rr * (DH + 1) + d] =
        row < S ? to_f32(q[base + static_cast<size_t>(row) * DH + d]) : 0.f;
  }

  constexpr int kCols = DH / 4;        // output columns per thread
  constexpr int kScores = kBlockK / 4;  // scores per thread per key tile
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  float m = -1e20f;  // == the reference's clamp applied to its -1e30 start
  float l = 0.f;

  const int n_ktiles = (len + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_ktiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's ks/vs/ps are no longer read
    for (int e = tid; e < kBlockK * DH; e += kThreads) {
      const int rr = e / DH, d = e % DH, row = k0 + rr;
      float kv = 0.f, vv = 0.f;
      if (row < S) {
        const size_t off = base + static_cast<size_t>(row) * DH + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[rr * (DH + 1) + d] = kv;
      vs[rr * DH + d] = vv;
    }
    __syncthreads();

    float s[kScores];
#pragma unroll
    for (int j = 0; j < kScores; ++j) s[j] = 0.f;
    const float* qrow = qs + r * (DH + 1);
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int j = 0; j < kScores; ++j)
        s[j] = fmaf(qv, ks[(c + 4 * j) * (DH + 1) + d], s[j]);
    }

    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kScores; ++j) {
      const int col = k0 + c + 4 * j;
      s[j] = col < len ? s[j] * scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(fmaxf(m, mx), -1e20f);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kScores; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      ps[r * (kBlockK + 1) + c + 4 * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] *= alpha;
    const float* prow = ps + r * (kBlockK + 1);
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      const float p = prow[kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[j] = fmaf(p, vs[kk * DH + c + 4 * j], acc[j]);
    }
  }

  const int row = q0 + r;
  if (row < S) {
    const float l_safe = fmaxf(l, 1e-30f);
    T* orow = out + base + static_cast<size_t>(row) * DH;
#pragma unroll
    for (int j = 0; j < kCols; ++j) orow[c + 4 * j] = from_f32<T>(acc[j] / l_safe);
    if (lse != nullptr && c == 0)
      lse[static_cast<size_t>(bh) * S + row] = m + logf(l_safe);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* lse, int B, int H,
                   int S, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  auto kernel = flash_fwd_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_qtiles = (S + kBlockQ - 1) / kBlockQ;
  const long long n_blocks = static_cast<long long>(n_qtiles) * B * H;
  if (n_blocks == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(n_blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), lse, H, S,
      n_qtiles, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* lengths, void* out, float* lse, int B, int H,
                     int S, int Dh, float scale, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, lengths, out, lse, B, H, S, scale, stream);
    case 32: return launch<T, 32>(q, k, v, lengths, out, lse, B, H, S, scale, stream);
    case 64: return launch<T, 64>(q, k, v, lengths, out, lse, B, H, S, scale, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, out, lse, B, H, S, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. lse may be null. Returns a cudaError_t.
int flash_fwd(int dtype, const void* q, const void* k, const void* v,
              const int* lengths, void* out, float* lse, int B, int H, int S,
              int Dh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, lengths, out, lse, B, H, S, Dh, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, lengths, out, lse, B, H, S, Dh,
                                   scale, st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
