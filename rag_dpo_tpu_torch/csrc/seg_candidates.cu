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
// Any seg dividing block_n and any 1 <= per_seg <= seg, as the reference
// takes. A span is a run of at most 512 rows: lcm(seg, 128) rows where that
// is at most 512 (a whole number of segments and of 128-row tiles), else as
// many whole segments as 512 rows hold, the last 128-row tile cut short.
// A segment longer than 512 rows is cut into pieces of 512 (the last one
// shorter), a span each. A block takes a query tile and walks spans (span
// blockIdx.y, then + gridDim.y): for each 128-row tile the product, then
// score + penalty in one f32 add into a [TQ][span] score tile in shared
// memory. Then one warp per (query, segment or piece) runs the rounds: each
// lane scans its lanes of the segment for its best (strict >, so its first
// among equal scores; lanes past a short segment hold -inf), a butterfly of
// shuffles takes the best (larger score, then lower row), lane 0 writes the
// pick and masks it. A piece's rounds go to a scratch [Q, segments, pieces,
// per_seg] of (score, row), its picks masked to -inf so none repeats; a
// second kernel, one warp per (query, segment), then takes per_seg rounds
// over its pieces' picks by (score desc, row asc). The top per_seg of a
// segment in that order is the top of the union of its pieces' tops, so the
// merge gives the single pass's strip. No atomics: the same inputs give the
// same bits.
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

#include <math.h>

#include <algorithm>

#include "tile_product.cuh"
#include "tma_product.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kMaxSpan = 512;
constexpr int kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;
constexpr float kPastPenalty = -5e29f;
constexpr int kNoRow = 0x7fffffff;  // loses every tie

// Span sp: its first row and rows, and the segments (or the one piece) it
// holds: segs of them from segment sg0, or piece `piece` of segment sg0.
struct Span {
  int row0, rows, segs, sg0, piece;
};

__device__ __forceinline__ Span span_at(int sp, int span, int seg,
                                        int pieces) {
  if (pieces == 1) {
    const int segs = span / seg;
    return {sp * span, span, segs, sp * segs, 0};
  }
  const int sg = sp / pieces, p = sp - sg * pieces;
  return {sg * seg + p * kMaxSpan, min(kMaxSpan, seg - p * kMaxSpan), 1, sg,
          p};
}

// (best, pos) <- the larger score, then the lower position, over the warp
__device__ __forceinline__ void warp_best(float& best, int& pos) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int op = __shfl_xor_sync(0xffffffffu, pos, off);
    if (ob > best || (ob == best && op < pos)) { best = ob; pos = op; }
  }
}

// The rounds of every (query, segment) of span s, from the score tile sc
// (row qi at sc + qi·ld); one warp a task, eight warps. Whole segments write
// the strip; a piece (pieces > 1) writes its picks, (score, row), to the
// scratch out_s / out_i, -inf / kNoRow past a piece shorter than per_seg.
__device__ __forceinline__ void rounds(float* sc, int ld, int tq, int q0,
                                       int Q, const Span& s, int seg,
                                       int per_seg, int nseg, int n_segs,
                                       int pieces, float* out_s, int* out_i,
                                       int warp, int lane) {
  const int len = pieces == 1 ? seg : s.rows;  // rows of a task
  const int picks = min(per_seg, len);
  for (int task = warp; task < tq * s.segs; task += kWarps) {
    const int qi = task / s.segs, sl = task - qi * s.segs;
    const int sg = s.sg0 + sl;  // the segment's global number
    if (q0 + qi >= Q || sg >= n_segs) continue;  // warp-uniform
    float* v = sc + qi * ld + sl * seg;
    const int first = pieces == 1 ? sg * seg : s.row0;  // the task's row 0
    size_t out, step;
    if (pieces == 1) {
      const int j = sg / nseg, g = sg - j * nseg;
      out = static_cast<size_t>(q0 + qi) * n_segs * per_seg +
            static_cast<size_t>(j) * nseg * per_seg + g;
      step = nseg;
    } else {
      out = ((static_cast<size_t>(q0 + qi) * n_segs + sg) * pieces +
             s.piece) * per_seg;
      step = 1;
    }
    for (int r = 0; r < picks; ++r) {
      float best = lane < len ? v[lane] : -INFINITY;
      int pos = lane < len ? lane : kNoRow;
      for (int p = lane + 32; p < len; p += 32) {
        const float x = v[p];
        if (x > best) { best = x; pos = p; }
      }
      warp_best(best, pos);
      if (lane == 0) {
        out_s[out + r * step] = best;
        if (pieces == 1) {
          out_i[out + r * step] = best > kPastPenalty ? first + pos : -1;
          v[pos] = kNegInf;
        } else {
          out_i[out + r * step] = first + pos;
          v[pos] = -INFINITY;
        }
      }
      __syncwarp();
    }
    if (lane == 0)
      for (int r = picks; r < per_seg; ++r) {
        out_s[out + r * step] = -INFINITY;
        out_i[out + r * step] = kNoRow;
      }
  }
}

// The second pass for segments cut into pieces: one warp per (query,
// segment) takes per_seg rounds over the pieces' picks, by (score desc, row
// asc), into the strip; a taken pick becomes (-inf, kNoRow). A round after
// the first is at least -1e30, as the single pass's masked picks are.
__global__ void __launch_bounds__(kThreads)
merge_pieces(float* __restrict__ scr_s, int* __restrict__ scr_i, int Q,
             int n_segs, int pieces, int per_seg, int nseg,
             float* __restrict__ out_s, int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int n = pieces * per_seg;
  const long long tasks = static_cast<long long>(Q) * n_segs;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long task = (static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x) >> 5;
       task < tasks; task += warps) {
    const int qi = static_cast<int>(task / n_segs);
    const int sg = static_cast<int>(task - static_cast<long long>(qi) * n_segs);
    float* cs = scr_s + task * n;
    int* ci = scr_i + task * n;
    const int j = sg / nseg, g = sg - j * nseg;
    const size_t out = static_cast<size_t>(qi) * n_segs * per_seg +
                       static_cast<size_t>(j) * nseg * per_seg + g;
    for (int r = 0; r < per_seg; ++r) {
      float best = -INFINITY;
      int row = kNoRow, at = 0;
      for (int i = lane; i < n; i += 32) {
        const float x = cs[i];
        const int rr = ci[i];
        if (x > best || (x == best && rr < row)) { best = x; row = rr; at = i; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int orow = __shfl_xor_sync(0xffffffffu, row, off);
        const int oat = __shfl_xor_sync(0xffffffffu, at, off);
        if (ob > best || (ob == best && orow < row)) {
          best = ob; row = orow; at = oat;
        }
      }
      if (lane == 0) {
        out_s[out + static_cast<size_t>(r) * nseg] =
            r > 0 ? fmaxf(best, kNegInf) : best;
        out_i[out + static_cast<size_t>(r) * nseg] =
            best > kPastPenalty ? row : -1;
        cs[at] = -INFINITY;
        ci[at] = kNoRow;
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
               int pieces, int n_spans, float* __restrict__ out_s,
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
    const Span s = span_at(sp, span, seg, pieces);
    for (int t = 0; t < s.rows; t += kTileN) {
      const int base = s.row0 + t;
      float acc[MQ][8] = {};
      if (base < N)  // block-uniform: a tile wholly past N is all -1e30
        tile_product<float, MQ>(q, e, Q, N, D, q0, base, tid, qs, es, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(tx, j);
        if (t + c >= s.rows) continue;  // a cut tile: the next span's rows
        const int r = base + c;
        float add = 0.f;
        if (pen != nullptr) add = r < P ? pen[r] : kPastPenalty;
#pragma unroll
        for (int i = 0; i < MQ; ++i)
          sc[(ty * MQ + i) * ld + t + c] = r < N ? acc[i][j] + add : kNegInf;
      }
    }
    __syncthreads();
    rounds(sc, ld, TQ, q0, Q, s, seg, per_seg, nseg, n_segs, pieces, out_s,
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
                  int pieces, int n_spans, int stages,
                  float* __restrict__ out_s, int* __restrict__ out_i) {
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
      for (int sp = blockIdx.y; sp < n_spans; sp += gridDim.y) {
        const Span s = span_at(sp, span, seg, pieces);
        for (int t = 0; t < s.rows; t += kRowTile)
          if (s.row0 + t < N)
            produce_tile<NQ>(&map_e, &map_q, ring, n_slices, it,
                             s.row0 + t, q0);
      }
    return;
  }

  for (int sp = blockIdx.y; sp < n_spans; sp += gridDim.y) {
    const Span s = span_at(sp, span, seg, pieces);
    for (int t = 0; t < s.rows; t += kRowTile) {
      const int base = s.row0 + t;
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
        const int c = t + frag_row(tid, i);
        if (c < s.rows)  // a cut tile: the next span's rows
          sc[frag_col(tid, i) * ld + c] = in[h] ? acc[i] + add[h] : kNegInf;
      }
    }
    consumer_sync();
    rounds(sc, ld, NQ, q0, Q, s, seg, per_seg, nseg, n_segs, pieces, out_s,
           out_i, warp, lane);
    consumer_sync();  // the next span overwrites the score tile
  }
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// The rows of a span (at most kMaxSpan) for segments of seg rows, and the
// pieces a segment is cut into (1 unless seg > kMaxSpan);
// ops/topk.py::candidates_plan computes the same.
void span_plan(int seg, int& span, int& pieces) {
  pieces = 1;
  if (seg > kMaxSpan) {
    span = kMaxSpan;
    pieces = (seg + kMaxSpan - 1) / kMaxSpan;
    return;
  }
  span = seg / gcd(seg, kTileN) * kTileN;
  if (span > kMaxSpan) span = seg * (kMaxSpan / seg);
}

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
                        int nseg, int n_segs, int pieces, int n_spans,
                        int n_blocks, float* out_s, int* out_i,
                        cudaStream_t st) {
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
      N, D, span, seg, per_seg, nseg, n_segs, pieces, n_spans, out_s, out_i);
  return cudaGetLastError();
}

template <int NQ>
cudaError_t launch_tc(const void* q, const void* e, const float* pen, int P,
                      int Q, int N, int D, int span, int seg, int per_seg,
                      int nseg, int n_segs, int pieces, int n_spans,
                      int n_blocks, int stages, float* out_s, int* out_i,
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
      pieces, n_spans, stages, out_s, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 = f32 (SIMT), 1 = bf16 (wgmma), q and e alike; q [Q, D], e [N, D],
// both contiguous and 16-byte aligned, D % 8 == 0; penalty [P] f32 or null;
// out_* [Q, W] with W = ceil(N / block_n)·(block_n / seg)·per_seg. Takes any
// seg dividing block_n and 1 <= per_seg <= seg. For seg > 512 it needs the
// scratch scr_s / scr_i of Q·(W / per_seg)·ceil(seg / 512)·per_seg entries
// each (null otherwise). The launch plan (ops/topk.py::candidates_plan)
// gives tile_q (f32: 16 or 64; bf16: 8, 16, 32, 64 or 128), stages (the
// bf16 ring's depth, >= 3) and n_blocks, the blocks over spans (<= 65,535).
// Returns a cudaError_t.
int fused_candidates(int dtype, const void* q, const void* e,
                     const float* penalty, int P, int Q, int N, int D,
                     int block_n, int seg, int per_seg, int tile_q,
                     int stages, int n_blocks, float* scr_s, int* scr_i,
                     float* out_s, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q <= 0 || N <= 0 || D < 8 || D % 8 != 0 || seg <= 0 ||
      block_n <= 0 || block_n % seg != 0 || per_seg < 1 ||
      per_seg > seg || n_blocks < 1 || n_blocks > 65535 ||
      (dtype != 0 && dtype != 1) || (penalty != nullptr && P < 0) ||
      (dtype == 0 && tile_q != 16 && tile_q != 64) ||
      (dtype == 1 && (!tc_tile_ok(tile_q) || stages < 3)))
    return cudaErrorInvalidValue;
  int span, pieces;
  span_plan(seg, span, pieces);
  const long long nb = (static_cast<long long>(N) + block_n - 1) / block_n;
  if (nb * block_n > 0x7fffffffLL ||
      (pieces > 1 && (scr_s == nullptr || scr_i == nullptr)))
    return cudaErrorInvalidValue;
  const int nseg = block_n / seg;
  const int n_segs = static_cast<int>(nb) * nseg;
  const int n_spans =
      pieces > 1 ? n_segs * pieces
                 : static_cast<int>((static_cast<long long>(n_segs) * seg +
                                     span - 1) / span);
  // the first pass writes the strip, or the pieces' picks to the scratch
  float* to_s = pieces > 1 ? scr_s : out_s;
  int* to_i = pieces > 1 ? scr_i : out_i;
  cudaError_t err;
  if (dtype == 0) {
    err = tile_q == 16
              ? launch_simt<1>(q, e, penalty, P, Q, N, D, span, seg, per_seg,
                               nseg, n_segs, pieces, n_spans, n_blocks, to_s,
                               to_i, st)
              : launch_simt<4>(q, e, penalty, P, Q, N, D, span, seg, per_seg,
                               nseg, n_segs, pieces, n_spans, n_blocks, to_s,
                               to_i, st);
  } else {
#define K5_TC(NQ)                                                            \
  launch_tc<NQ>(q, e, penalty, P, Q, N, D, span, seg, per_seg, nseg, n_segs, \
                pieces, n_spans, n_blocks, stages, to_s, to_i, st)
    switch (tile_q) {
      case 8: err = K5_TC(8); break;
      case 16: err = K5_TC(16); break;
      case 32: err = K5_TC(32); break;
      case 64: err = K5_TC(64); break;
      default: err = K5_TC(128);
    }
#undef K5_TC
  }
  if (err != cudaSuccess || pieces == 1) return err;
  const long long warps = static_cast<long long>(Q) * n_segs;
  const int blocks =
      static_cast<int>(std::min<long long>((warps + kWarps - 1) / kWarps,
                                           1 << 20));
  merge_pieces<<<blocks, kThreads, 0, st>>>(scr_s, scr_i, Q, n_segs, pieces,
                                            per_seg, nseg, out_s, out_i);
  return cudaGetLastError();
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
