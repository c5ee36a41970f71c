// Per-segment dense candidates for Hopper (sm_90a): [Q,D]·[N,D]ᵀ (+ penalty),
// and of every seg-wide segment of rows its best per_seg rows, written to a
// [Q, W] candidate strip without ever writing the [Q,N] scores.
//
// Replaces the Pallas TPU kernel rag_dpo_tpu/ops/topk.py::_seg_candidates_kernel
// (phase 1 of fused_candidates_topk); phase 2, the exact selection over the
// strip, stays plain torch as it stays XLA there.
//
//   score[q, n] = sum_d q[q, d] * e[n, d] + pen[n]   (rows n >= P get -5e29;
//                                                     no penalty adds +0)
//   rows n >= N score -1e30
//
// Segment g of row block j (block_n rows, nseg = block_n / seg segments)
// holds rows (j·nseg + g)·seg ... + seg - 1. Round r = 0 .. per_seg-1 takes
// the segment's largest score and, among equal scores, its first row; then
// masks that row to -1e30 for the rounds after it, as the reference does (so
// a round after the first never reads below -1e30). A pick scoring <= -5e29
// gets id -1. The strip is JAX's layout with the Mosaic lane padding
// dropped: block-major, then round, then segment, position
// j·nseg·per_seg + r·nseg + g, W = nb·nseg·per_seg with nb = ceil(N/block_n).
//
// Grid (spans, query tiles), 256 threads. A span is lcm(seg, 128) rows (at
// most 512), a whole number of segments and of 128-row tiles. A block takes
// one span and 16 or 64 queries: for each 128-row tile the SIMT product of
// csrc/tile_product.cuh (shared with K4), then score + penalty in one f32 add
// into a [TQ][span] score tile in shared memory. Then one warp per (query,
// segment) runs the rounds: each lane scans its lanes of the segment for its
// best (strict >, so its first among equal scores), a butterfly of shuffles
// takes the best (larger score, then lower row), lane 0 writes the pick and
// masks it. No atomics: the same inputs give the same bits.
//
// What bounds it on an H100: the products, as K4. 2·Q·N·D flops on the CUDA
// cores in f32 (67 TFLOP/s) against bytes N·D·sizeof(T) read once plus the
// [Q, W] strip written (3.35 TB/s). The rounds cost per_seg·seg/32 shared
// loads and 10 shuffles a (query, segment), small beside the seg·D products.
// wgmma (bf16 products are exact in f32) is for a later PR.

#include "tile_product.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kMaxSpan = 512;
constexpr float kNegInf = -1e30f;
constexpr float kPastPenalty = -5e29f;

template <typename T, int MQ>
__global__ void __launch_bounds__(kThreads, 2)
seg_candidates(const T* __restrict__ q, const T* __restrict__ e,
               const float* __restrict__ pen, int P, int Q, int N, int D,
               int span, int seg, int per_seg, int nseg, int n_segs,
               float* __restrict__ out_s, int* __restrict__ out_i) {
  constexpr int TQ = 16 * MQ;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kChunk][TQ + 4]
  float* es = qs + kChunk * (TQ + 4);           // [kChunk][kLdE]
  float* sc = es + kChunk * kLdE;               // [TQ][ld]
  const int ld = span + 1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.y * TQ;
  const int row0 = blockIdx.x * span;

  for (int t = 0; t < span; t += kTileN) {
    const int base = row0 + t;
    float acc[MQ][8] = {};
    if (base < N)  // block-uniform: a tile wholly past N is all -1e30
      tile_product<T, MQ>(q, e, Q, N, D, q0, base, tid, qs, es, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(tx, j);
      const int r = base + c;
      float add = 0.f;
      if (pen != nullptr) add = r < P ? pen[r] : kPastPenalty;
#pragma unroll
      for (int i = 0; i < MQ; ++i)
        sc[(ty * MQ + i) * ld + t + c] = r < N ? acc[i][j] + add : kNegInf;
    }
  }
  __syncthreads();

  const int segs = span / seg;  // segments in the span
  const int width = n_segs * per_seg;
  for (int task = warp; task < TQ * segs; task += kWarps) {
    const int qi = task / segs, sl = task - qi * segs;
    const int sg = blockIdx.x * segs + sl;  // the segment's global number
    if (q0 + qi >= Q || sg >= n_segs) continue;  // warp-uniform
    float* v = sc + qi * ld + sl * seg;
    const int j = sg / nseg, g = sg - j * nseg;
    const size_t out = static_cast<size_t>(q0 + qi) * width +
                       static_cast<size_t>(j) * nseg * per_seg + g;
    for (int r = 0; r < per_seg; ++r) {
      float best = v[lane];
      int pos = lane;
      for (int p = lane + 32; p < seg; p += 32) {
        const float x = v[p];
        if (x > best) { best = x; pos = p; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int op = __shfl_xor_sync(0xffffffffu, pos, off);
        if (ob > best || (ob == best && op < pos)) { best = ob; pos = op; }
      }
      if (lane == 0) {
        out_s[out + static_cast<size_t>(r) * nseg] = best;
        out_i[out + static_cast<size_t>(r) * nseg] =
            best > kPastPenalty ? sg * seg + pos : -1;
        v[pos] = kNegInf;
      }
      __syncwarp();
    }
  }
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

template <typename T, int MQ>
cudaError_t launch(const void* q, const void* e, const float* pen, int P,
                   int Q, int N, int D, int span, int seg, int per_seg,
                   int nseg, int n_segs, float* out_s, int* out_i,
                   cudaStream_t st) {
  constexpr int TQ = 16 * MQ;
  const size_t smem =
      sizeof(float) * (product_smem_floats<MQ>() + TQ * (span + 1));
  cudaError_t err = cudaFuncSetAttribute(
      seg_candidates<T, MQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(n_segs) * seg;
  const dim3 grid(static_cast<unsigned>((rows + span - 1) / span),
                  (Q + TQ - 1) / TQ);
  seg_candidates<T, MQ><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(e), pen, P, Q, N, D,
      span, seg, per_seg, nseg, n_segs, out_s, out_i);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for(int tile_q, const void* q, const void* e,
                       const float* pen, int P, int Q, int N, int D, int span,
                       int seg, int per_seg, int nseg, int n_segs,
                       float* out_s, int* out_i, cudaStream_t st) {
  if (tile_q == 16)
    return launch<T, 1>(q, e, pen, P, Q, N, D, span, seg, per_seg, nseg,
                        n_segs, out_s, out_i, st);
  return launch<T, 4>(q, e, pen, P, Q, N, D, span, seg, per_seg, nseg,
                      n_segs, out_s, out_i, st);
}

}  // namespace

extern "C" {

// dtype 0 = f32, 1 = bf16 (q and e alike); q [Q, D], e [N, D], both
// contiguous and 16-byte aligned; penalty [P] f32 or null; out_* [Q, W] with
// W = ceil(N / block_n)·(block_n / seg)·per_seg. Needs 8 <= D <= 1024 with
// D % 8 == 0, seg a multiple of 32 dividing block_n with lcm(seg, 128) <= 512,
// 1 <= per_seg <= seg, tile_q 16 or 64, and Q ≤ 65,535·tile_q. Returns a
// cudaError_t.
int fused_candidates(int dtype, const void* q, const void* e,
                     const float* penalty, int P, int Q, int N, int D,
                     int block_n, int seg, int per_seg, int tile_q,
                     float* out_s, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q <= 0 || N <= 0 || D < 8 || D > 1024 || D % 8 != 0 || seg <= 0 ||
      seg % 32 != 0 || block_n <= 0 || block_n % seg != 0 || per_seg < 1 ||
      per_seg > seg || (tile_q != 16 && tile_q != 64) ||
      (Q + tile_q - 1) / tile_q > 65535 || (dtype != 0 && dtype != 1) ||
      (penalty != nullptr && P < 0))
    return cudaErrorInvalidValue;
  const int span = seg / gcd(seg, kTileN) * kTileN;
  const long long nb = (static_cast<long long>(N) + block_n - 1) / block_n;
  if (span > kMaxSpan || nb * block_n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int nseg = block_n / seg;
  const int n_segs = static_cast<int>(nb) * nseg;
  return dtype == 0
             ? launch_for<float>(tile_q, q, e, penalty, P, Q, N, D, span, seg,
                                 per_seg, nseg, n_segs, out_s, out_i, st)
             : launch_for<__nv_bfloat16>(tile_q, q, e, penalty, P, Q, N, D,
                                         span, seg, per_seg, nseg, n_segs,
                                         out_s, out_i, st);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
