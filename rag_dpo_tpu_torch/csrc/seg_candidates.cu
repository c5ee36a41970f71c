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
// A span is lcm(seg, 128) rows (at most 512), a whole number of segments and
// of 128-row tiles. A block takes a query tile and walks spans (span
// blockIdx.y, then + gridDim.y): for each 128-row tile the product, then
// score + penalty in one f32 add into a [TQ][span] score tile in shared
// memory. Then one warp per (query, segment) runs the rounds: each lane
// scans its lanes of the segment for its best (strict >, so its first among
// equal scores), a butterfly of shuffles takes the best (larger score, then
// lower row), lane 0 writes the pick and masks it. No atomics: the same
// inputs give the same bits.
//
// The product, as K4's (csrc/fused_topk.cu): bf16 inputs on the tensor cores
// (csrc/tma_product.cuh: TMA-fed wgmma, the query tile of 8 ... 128 as the N
// side, 256 consumer threads and a producer warp that loads the next tile
// while the rounds run); f32 inputs on the CUDA cores (csrc/tile_product.cuh,
// 16 or 64 queries, 256 threads), since TF32 would give up ROADMAP C-5's
// precision.
//
// What bounds it on an H100: the bytes, as K4. At Q 256 over 1M × 1024 bf16
// rows, 2.05 GB read once plus the [Q, W] strip written take 0.62 ms at
// 3.35 TB/s, the products 0.543 ms on the bf16 tensor cores (989 TFLOP/s)
// against 8 ms on the f32 CUDA cores. The rounds cost per_seg·seg/32 shared
// loads and 10 shuffles a (query, segment), small beside the seg·D products.

#include "tile_product.cuh"
#include "tma_product.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kMaxSpan = 512;
constexpr int kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;
constexpr float kPastPenalty = -5e29f;

// The rounds of every (query, segment) of span sp, from the score tile sc
// (row qi at sc + qi·ld); one warp a task, eight warps.
__device__ __forceinline__ void rounds(float* sc, int ld, int tq, int q0,
                                       int Q, int sp, int span, int seg,
                                       int per_seg, int nseg, int n_segs,
                                       float* out_s, int* out_i, int warp,
                                       int lane) {
  const int segs = span / seg;  // segments in the span
  const int width = n_segs * per_seg;
  for (int task = warp; task < tq * segs; task += kWarps) {
    const int qi = task / segs, sl = task - qi * segs;
    const int sg = sp * segs + sl;  // the segment's global number
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

// f32: the SIMT product, 256 threads, grid (query tiles, span blocks)
template <int MQ>
__global__ void __launch_bounds__(kThreads, 1)
seg_candidates(const float* __restrict__ q, const float* __restrict__ e,
               const float* __restrict__ pen, int P, int Q, int N, int D,
               int span, int seg, int per_seg, int nseg, int n_segs,
               int n_spans, float* __restrict__ out_s,
               int* __restrict__ out_i) {
  constexpr int TQ = 16 * MQ;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kChunk][TQ + 4]
  float* es = qs + kChunk * (TQ + 4);           // [kChunk][kLdE]
  float* sc = es + kChunk * kLdE;               // [TQ][ld]
  const int ld = span + 1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * TQ;

  for (int sp = blockIdx.y; sp < n_spans; sp += gridDim.y) {
    const int row0 = sp * span;
    for (int t = 0; t < span; t += kTileN) {
      const int base = row0 + t;
      float acc[MQ][8] = {};
      if (base < N)  // block-uniform: a tile wholly past N is all -1e30
        tile_product<float, MQ>(q, e, Q, N, D, q0, base, tid, qs, es, acc);
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
    rounds(sc, ld, TQ, q0, Q, sp, span, seg, per_seg, nseg, n_segs, out_s,
           out_i, warp, lane);
    __syncthreads();
  }
}

// bf16: the wgmma product, 288 threads, grid (query tiles, span blocks)
template <int NQ>
__global__ void __launch_bounds__(kTmaThreads, 1)
seg_candidates_tc(const __grid_constant__ CUtensorMap map_e,
                  const __grid_constant__ CUtensorMap map_q,
                  const float* __restrict__ pen, int P, int Q, int N, int D,
                  int span, int seg, int per_seg, int nseg, int n_segs,
                  int n_spans, int stages, float* __restrict__ out_s,
                  int* __restrict__ out_i) {
  extern __shared__ uint8_t smem_raw[];
  Ring ring;
  float* sc = reinterpret_cast<float*>(
      ring_setup(smem_raw, NQ, stages, ring));  // [NQ][ld]
  __syncthreads();
  const int ld = span + 4;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * NQ;
  const int n_slices = (D + kSliceD - 1) / kSliceD;
  uint32_t it = 0;

  if (warp == kConsumerWarps) {  // the producer
    if (lane == 0)
      for (int sp = blockIdx.y; sp < n_spans; sp += gridDim.y)
        for (int t = 0; t < span; t += kRowTile)
          if (sp * span + t < N)
            produce_tile<NQ>(&map_e, &map_q, ring, n_slices, it,
                             sp * span + t, q0);
    return;
  }

  for (int sp = blockIdx.y; sp < n_spans; sp += gridDim.y) {
    for (int t = 0; t < span; t += kRowTile) {
      const int base = sp * span + t;
      float acc[NQ / 2];
      if (base < N) {  // block-uniform: a tile wholly past N is all -1e30
        consume_tile<NQ>(ring, n_slices, it, tid, acc);
      } else {
#pragma unroll
        for (int i = 0; i < NQ / 2; ++i) acc[i] = 0.f;
      }
      float add[2] = {0.f, 0.f};
      bool in[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = base + frag_row(tid, 2 * h);
        in[h] = r < N;
        if (pen != nullptr) add[h] = r < P ? pen[r] : kPastPenalty;
      }
#pragma unroll
      for (int i = 0; i < NQ / 2; ++i) {
        const int h = (i >> 1) & 1;
        sc[frag_col(tid, i) * ld + t + frag_row(tid, i)] =
            in[h] ? acc[i] + add[h] : kNegInf;
      }
    }
    consumer_sync();
    rounds(sc, ld, NQ, q0, Q, sp, span, seg, per_seg, nseg, n_segs, out_s,
           out_i, warp, lane);
    consumer_sync();  // the next span overwrites the score tile
  }
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// shared bytes of a launch with query tile tq over spans of `span` rows
size_t cand_smem(int dtype, int tq, int stages, int span) {
  if (dtype == 0)
    return sizeof(float) * ((tq == 16 ? product_smem_floats<1>()
                                      : product_smem_floats<4>()) +
                            static_cast<size_t>(tq) * (span + 1));
  return ring_bytes(tq, stages) + sizeof(float) * tq * (span + 4);
}

template <int MQ>
cudaError_t launch_simt(const void* q, const void* e, const float* pen, int P,
                        int Q, int N, int D, int span, int seg, int per_seg,
                        int nseg, int n_segs, int n_spans, int n_blocks,
                        float* out_s, int* out_i, cudaStream_t st) {
  constexpr int TQ = 16 * MQ;
  const size_t smem = cand_smem(0, TQ, 0, span);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      seg_candidates<MQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + TQ - 1) / TQ, n_blocks);
  seg_candidates<MQ><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(e), pen, P, Q,
      N, D, span, seg, per_seg, nseg, n_segs, n_spans, out_s, out_i);
  return cudaGetLastError();
}

template <int NQ>
cudaError_t launch_tc(const void* q, const void* e, const float* pen, int P,
                      int Q, int N, int D, int span, int seg, int per_seg,
                      int nseg, int n_segs, int n_spans, int n_blocks,
                      int stages, float* out_s, int* out_i,
                      cudaStream_t st) {
  const size_t smem = cand_smem(1, NQ, stages, span);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  CUtensorMap map_e, map_q;
  cudaError_t err = bf16_map(&map_e, e, N, D, kRowTile);
  if (err == cudaSuccess) err = bf16_map(&map_q, q, Q, D, NQ);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(seg_candidates_tc<NQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + NQ - 1) / NQ, n_blocks);
  seg_candidates_tc<NQ><<<grid, kTmaThreads, smem, st>>>(
      map_e, map_q, pen, P, Q, N, D, span, seg, per_seg, nseg, n_segs,
      n_spans, stages, out_s, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 = f32 (SIMT), 1 = bf16 (wgmma), q and e alike; q [Q, D], e [N, D],
// both contiguous and 16-byte aligned, D % 8 == 0; penalty [P] f32 or null;
// out_* [Q, W] with W = ceil(N / block_n)·(block_n / seg)·per_seg. Needs seg
// a multiple of 32 dividing block_n with lcm(seg, 128) <= 512 and
// 1 <= per_seg <= seg. The launch plan (ops/topk.py::candidates_plan) gives
// tile_q (f32: 16 or 64; bf16: 8, 16, 32, 64 or 128), stages (the bf16
// ring's depth, >= 3) and n_blocks, the blocks over spans (<= 65,535).
// Returns a cudaError_t.
int fused_candidates(int dtype, const void* q, const void* e,
                     const float* penalty, int P, int Q, int N, int D,
                     int block_n, int seg, int per_seg, int tile_q,
                     int stages, int n_blocks, float* out_s, int* out_i,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q <= 0 || N <= 0 || D < 8 || D % 8 != 0 || seg <= 0 ||
      seg % 32 != 0 || block_n <= 0 || block_n % seg != 0 || per_seg < 1 ||
      per_seg > seg || n_blocks < 1 || n_blocks > 65535 ||
      (dtype != 0 && dtype != 1) || (penalty != nullptr && P < 0) ||
      (dtype == 0 && tile_q != 16 && tile_q != 64) ||
      (dtype == 1 && (!tc_tile_ok(tile_q) || stages < 3)))
    return cudaErrorInvalidValue;
  const int span = seg / gcd(seg, kTileN) * kTileN;
  const long long nb = (static_cast<long long>(N) + block_n - 1) / block_n;
  if (span > kMaxSpan || nb * block_n > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int nseg = block_n / seg;
  const int n_segs = static_cast<int>(nb) * nseg;
  const int n_spans = static_cast<int>(
      (static_cast<long long>(n_segs) * seg + span - 1) / span);
  if (dtype == 0) {
    if (tile_q == 16)
      return launch_simt<1>(q, e, penalty, P, Q, N, D, span, seg, per_seg,
                            nseg, n_segs, n_spans, n_blocks, out_s, out_i,
                            st);
    return launch_simt<4>(q, e, penalty, P, Q, N, D, span, seg, per_seg,
                          nseg, n_segs, n_spans, n_blocks, out_s, out_i, st);
  }
#define K5_TC(NQ)                                                           \
  return launch_tc<NQ>(q, e, penalty, P, Q, N, D, span, seg, per_seg, nseg, \
                       n_segs, n_spans, n_blocks, stages, out_s, out_i, st)
  switch (tile_q) {
    case 8: K5_TC(8);
    case 16: K5_TC(16);
    case 32: K5_TC(32);
    case 64: K5_TC(64);
    default: K5_TC(128);
  }
#undef K5_TC
}

// Shared bytes of a launch for (dtype, tile_q, stages, span);
// ops/topk.py::candidates_plan computes the same on the CPU, and the cuda
// tests hold it to this.
long long fused_candidates_smem(int dtype, int tile_q, int stages,
                                int span) {
  return static_cast<long long>(cand_smem(dtype, tile_q, stages, span));
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
