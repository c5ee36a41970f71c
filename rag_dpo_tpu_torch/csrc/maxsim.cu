// ColBERT MaxSim late interaction for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel rag_dpo_tpu/ops/maxsim.py:43
// (_maxsim_kernel; entry `maxsim` :72, pallas_call :96):
//
//   score[q, c] = sum_{valid l} max_{valid m} <qv[q, l], dv[c, m]>
//
// Masked doc tokens count as -1e30 and every max is clamped at -1e30, so a
// candidate with no valid token scores -1e30 per valid query token; masked
// query tokens add 0, and a query with none scores 0. The Pallas kernel
// flattens [C*LD, D], multiplies by the query tokens on the MXU and sums
// each query's tokens with a second product against a 0/1 `owner` matrix.
// Here each query's valid tokens are added directly.
//
// What bounds it on an H100 SXM (700 W): at the rerank (one question of 32
// tokens against 40 candidates of 256 stored f16 rows, ~140 valid each, D
// 1024) reading the valid doc rows once, ~11.4 MB, takes ~3.4 us at 3.35
// TB/s, and the products, two TF32 products a flop (below), ~1.5 us at 495
// TFLOP/s: bytes bound it. At the hermetic replay's shape (D 32, 96 rows)
// the work is well under a microsecond and a launch (~3 us) bounds it.
//
// What the design does about it:
// * Products on the tensor cores, mma.sync m16n8k8 TF32 (mma_sync.cuh):
//   doc rows are M (the A fragment, f16 / bf16 widened in registers, which
//   TF32 holds exactly), query tokens N, D is K. qv is f32 and is split a
//   fragment at a time into big = tf32(q) and small = q - big, so a product
//   is big.d + small.d and errs ~2^-21 of its size where one TF32 product
//   errs ~2^-11. f32 rows are split too: 3xTF32, as K1 runs f32. The
//   tensor core's f32 accumulator does not round to nearest, so the ALU
//   adds its sums into registers every few slices.
// * One block per (candidate, tile of 64 doc rows), tile-major (every
//   candidate's first tile, then its second, ...: with the prefix masks of
//   the rerank the tiles that hold rows fill the first wave). A tile with
//   no valid row exits at once; masked rows count -1e30 in the epilogue,
//   so any mask is right and a prefix mask wastes at most part of a tile.
// * Lane 0 of a producer warp streams D in slices of 128 bytes of a doc
//   row (64 f16 / bf16 or 32 f32 columns), with the query tile's same
//   columns, into a ring of 2-6 stages by TMA: one 2D box of 64 rows and
//   one or two of 32 query rows a stage, 128-byte swizzled, zero past D
//   and past the rows, counted in on a full mbarrier. Four consumer warps
//   (2 row halves x 2 column halves of a slice, 32 rows x 32 tokens each)
//   multiply and release the stage on an empty mbarrier, so the loads run
//   under the products. (Every warp issuing its own 16-byte cp.async, the
//   issue stalled under memory back-pressure and held the products back;
//   one bulk copy a row, the copy engine serialized ~1,500 small copies a
//   block.) A fragment row's lanes read rows 2p and 2p + 1 of the
//   fragment; these are stored rows p and p + 4 of an 8-row swizzle atom,
//   so the 16-byte reads of a quarter-warp fall on other banks. Rows that
//   are not 16-byte aligned (D % 8 for f16) go in element by element, into
//   the same layout.
// * Any Q, LQ, D, C, LD: the Q*LQ query tokens are one flat list walked in
//   tiles of 32 inside the block, D goes in slices (nothing is staged
//   whole), and the grid is C x ceil(LD / 64) in one dimension.
// * One launch, deterministic. The column halves' sums meet in shared
//   memory (in a fixed order), a block's max over its rows goes by
//   shuffles along the fragment's rows and across the row halves, then by
//   one atomicMax of the maximum's order-preserving bits into a [C, Q*LQ]
//   slot a token: max is exact, so any order gives the same bits. The last
//   block of a candidate (an atomic ticket) reads and zeroes the slots
//   and, for each query, adds its valid tokens' maxima in token order with
//   a compensated (Kahan) f32 sum (a plain running sum of 240 equal -1e30
//   maxima drifted 2.4e-6 from -1e30 * 240), then resets the ticket: the
//   workspace is left zeroed for the next call. No float atomic adds; the
//   same inputs give the same bits.

#include <cuda.h>  // CUtensorMap and the driver's encode signature
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int kConsumerWarps = 4;  // 2 row halves x 2 column halves
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr int kRows = 64;          // doc rows a block
constexpr int kTileQ = 32;         // query tokens a tile
constexpr int kAcc = 2 * 4 * 4;    // a lane's sums: 2 m-tiles x 4 n-tiles
constexpr int kFlush = 4;          // slices between flushes of the sums
constexpr int kRowBytes = 128;     // a row's bytes in one TMA box
constexpr int kMinStages = 2, kMaxStages = 6;
constexpr int kAlign = 1024;       // a 128-byte swizzle atom is 8 rows
constexpr int kSumChunk = 2048;    // maxima the last block stages at once
constexpr int kLaunches = 1;       // kernels a call launches
constexpr float kNegInf = -1e30f;

// A ring stage: the doc box (kRows x 128 bytes), then the query boxes
// (kTileQ x 32 f32 each: two for f16 / bf16 rows, one for f32)
template <typename T>
struct Slice {
  static constexpr int kCols = kRowBytes / static_cast<int>(sizeof(T));
  static constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // a chunk
  static constexpr int kQBoxes = kCols / 32;
  static constexpr int kDocBytes = kRows * kRowBytes;
  static constexpr int kQBoxBytes = kTileQ * kRowBytes;
  static constexpr int kStageBytes = kDocBytes + kQBoxes * kQBoxBytes;
};

template <typename T>
constexpr int smem_bytes(int stages) {
  return kAlign + stages * Slice<T>::kStageBytes;
}
static_assert(kMinStages * Slice<float>::kStageBytes >= kSumChunk * 4,
              "the last block's sum stages its maxima in the ring");

// the stored row of fragment row g within its 8: rows 2p and 2p + 1, which
// a quarter-warp reads together, are stored p and p + 4 of a swizzle atom
__device__ __forceinline__ int frag_row(int g) {
  return (g >> 1) | ((g & 1) << 2);
}
// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled box
__device__ __forceinline__ int swz(int r, int c) {
  return r * kRowBytes + ((c ^ (r & 7)) << 4);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __half zero<__half>() {
  return __ushort_as_half(0);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// the two 16-bit elements of w (the lower address in the low half),
// widened to f32 exactly
template <typename T>
__device__ __forceinline__ float2 widen2(uint32_t w);
template <>
__device__ __forceinline__ float2 widen2<__half>(uint32_t w) {
  return make_float2(
      __half2float(__ushort_as_half(static_cast<unsigned short>(w))),
      __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16))));
}
template <>
__device__ __forceinline__ float2 widen2<__nv_bfloat16>(uint32_t w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// x's bits in an order that unsigned comparison keeps; 0 is below every
// finite x and marks a slot no block wrote
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned k) {
  return k == 0u ? kNegInf
                 : __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu)
                                                     : ~k);
}

// Kahan step: adds x to the compensated sum (sum, carry)
__device__ __forceinline__ void kahan_add(float x, float& sum, float& carry) {
  const float y = __fsub_rn(x, carry);
  const float next = __fadd_rn(sum, y);
  carry = __fsub_rn(__fsub_rn(next, sum), y);
  sum = next;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// the arrival that also expects `bytes` more of copies on bar
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
// the box of `map` at (column c0, row c1) into dst, counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}
// a barrier of the consumer warps alone (the producer warp is elsewhere)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
}

struct Args {
  const float* qv;        // [Q * LQ, D]
  const uint8_t* q_mask;  // [Q * LQ]
  const void* dv;         // [C, LD, D]
  const uint8_t* d_mask;  // [C, LD]
  int Q, LQ, C, LD, D;
  int row_tiles;          // ceil(LD / kRows)
  int stages;
  bool tma_q, tma_d;      // rows by TMA (else element by element)
  unsigned* slots;        // [C, Q * LQ] order keys, zero between calls
  int* tickets;           // [C], zero between calls
  float* out;             // [Q, C]
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxsim_kernel(const __grid_constant__ CUtensorMap map_d,
              const __grid_constant__ CUtensorMap map_q, const Args a) {
  using S = Slice<T>;
  constexpr int KS = S::kCols, kPer = S::kPer;
  extern __shared__ unsigned char dyn_raw[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  // the column half kg = 1's sums, handed to kg = 0: [value][mh][lane]
  __shared__ float xch[kAcc * 2 * 32];
  __shared__ float red[2][kTileQ];  // a row half's max a token
  __shared__ uint8_t row_ok[kRows];
  __shared__ int is_last;
  unsigned char* dyn =
      dyn_raw + ((kAlign - (smem_addr(dyn_raw) & (kAlign - 1))) &
                 (kAlign - 1));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // tile-major: every candidate's first tile, then every second one, ...;
  // with prefix masks the tiles that hold rows come first
  const int c = blockIdx.x % a.C;
  const int r0 = blockIdx.x / a.C * kRows;
  const long long n_tok = static_cast<long long>(a.Q) * a.LQ;

  bool ok = false;
  if (tid < kRows) {
    const int r = r0 + tid;
    ok = r < a.LD && a.d_mask[static_cast<size_t>(c) * a.LD + r] != 0;
    row_ok[tid] = ok;
  }
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);  // the producer's arrival, and its bytes
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (__syncthreads_or(ok)) {
    const int n_slices = (a.D + KS - 1) / KS;
    const long long items = (n_tok + kTileQ - 1) / kTileQ * n_slices;
    const int stages = a.stages;

    if (warp == kConsumerWarps) {
      // The producer warp: for each item (query tile, slice) in order, the
      // doc rows' and the query tile's columns of the slice into ring
      // stage i % stages once the consumers have released it; lane 0
      // issues the TMA boxes, all lanes write rows that TMA cannot take.
      const T* crow = static_cast<const T*>(a.dv) +
                      static_cast<size_t>(c) * a.LD * a.D;
      int s = 0;
      uint32_t phase = 0;
      long long qt = 0;
      int sl = 0;
      for (long long i = 0; i < items; ++i) {
        mbar_wait(empty + s, phase ^ 1);
        const int col0 = sl * KS;
        unsigned char* st = dyn + s * S::kStageBytes;
        const long long tok0 = qt * kTileQ;
        if (!a.tma_d) {
          for (int e = lane; e < kRows * KS; e += 32) {
            const int r = e / KS, k = e % KS, col = col0 + k;
            reinterpret_cast<T*>(st + swz(r, k / kPer))[k % kPer] =
                row_ok[r] && col < a.D
                    ? crow[static_cast<size_t>(r0 + r) * a.D + col]
                    : zero<T>();
          }
        }
        if (!a.tma_q) {
          for (int e = lane; e < kTileQ * KS; e += 32) {
            const int r = e / KS, k = e % KS, col = col0 + k;
            const long long tok = tok0 + r;
            reinterpret_cast<float*>(st + S::kDocBytes +
                                     (k >> 5) * S::kQBoxBytes +
                                     swz(r, (k & 31) >> 2))[k & 3] =
                tok < n_tok && col < a.D ? a.qv[tok * a.D + col] : 0.f;
          }
        }
        __threadfence_block();
        __syncwarp();  // the lanes' stores before lane 0's release
        if (lane == 0) {
          mbar_arrive_tx(full + s,
                         (a.tma_d ? S::kDocBytes : 0) +
                             (a.tma_q ? S::kQBoxes * S::kQBoxBytes : 0));
          if (a.tma_d)
            tma_load(st, &map_d, full + s, col0, c * a.LD + r0);
          if (a.tma_q)
            for (int j = 0; j < S::kQBoxes; ++j)
              tma_load(st + S::kDocBytes + j * S::kQBoxBytes, &map_q,
                       full + s, col0 + 32 * j, static_cast<int>(tok0));
        }
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
        if (++sl == n_slices) {
          sl = 0;
          ++qt;
        }
      }
    } else {
      // The consumer warps. Warp (mh, kg): m-tile mt holds fragment rows g
      // and g + 8, stored rows 32 mh + 16 mt + (0 or 8) + frag_row(g); n-tile
      // nt holds tokens 8 nt + qn(g) as B's column and 8 nt + qn(2t), +
      // qn(2t + 1) as C's, qn the identity for f16 / bf16 rows (their lanes
      // read chunks 2t and 2t + 1 of a query row, rows 2p and 2p + 1
      // already on other banks) and frag_row for f32 (chunk t, as the doc
      // rows); kg picks half of each slice's columns.
      const int g = lane >> 2, t = lane & 3;
      const int mh = warp & 1, kg = warp >> 1;
      auto qn = [](int n) { return sizeof(T) == 4 ? frag_row(n) : n; };
      // Every product goes into acc on the tensor cores, whose f32
      // accumulator does not round to nearest: over 2,048 k-steps (D
      // 16,384) one sum drifted 7e-5 of its size. So the ALU adds acc into
      // tot every kFlush slices (and at a query tile's end), and acc starts
      // again.
      float acc[2][4][4], tot[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = tot[mt][nt][e] = 0.f;
      int unflushed = 0;
      auto flush = [&]() {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[mt][nt][e] += acc[mt][nt][e];
              acc[mt][nt][e] = 0.f;
            }
        unflushed = 0;
      };

      // the warp's half of stage s's columns
      auto compute = [&](int s) {
        const unsigned char* A = dyn + s * S::kStageBytes;
        const unsigned char* B = A + S::kDocBytes;
        if constexpr (sizeof(T) == 2) {
          // columns 32 kg .. + 31: lane t holds 32 kg + 8t .. + 7 (doc
          // chunk 4 kg + t; query box kg, chunks 2t and 2t + 1); mma k-step
          // s4 takes 8t + 2 s4 (as k = t) and 8t + 2 s4 + 1 (as k = t + 4),
          // in A and B alike
          uint4 ar[2][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              ar[mt][h] = *reinterpret_cast<const uint4*>(
                  A + swz(32 * mh + 16 * mt + 8 * h + frag_row(g),
                          4 * kg + t));
          float4 bq[4][2];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const unsigned char* bn = B + kg * S::kQBoxBytes;
            bq[nt][0] = *reinterpret_cast<const float4*>(
                bn + swz(8 * nt + g, 2 * t));
            bq[nt][1] = *reinterpret_cast<const float4*>(
                bn + swz(8 * nt + g, 2 * t + 1));
          }
#pragma unroll
          for (int s4 = 0; s4 < 4; ++s4) {
            uint32_t af[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const uint32_t lo[4] = {ar[mt][0].x, ar[mt][0].y, ar[mt][0].z,
                                      ar[mt][0].w};
              const uint32_t hi[4] = {ar[mt][1].x, ar[mt][1].y, ar[mt][1].z,
                                      ar[mt][1].w};
              const float2 x = widen2<T>(lo[s4]), y = widen2<T>(hi[s4]);
              af[mt][0] = __float_as_uint(x.x);
              af[mt][1] = __float_as_uint(y.x);
              af[mt][2] = __float_as_uint(x.y);
              af[mt][3] = __float_as_uint(y.y);
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const float4& q4 = bq[nt][s4 >> 1];
              uint32_t b0, s0, b1, s1;
              split((s4 & 1) ? q4.z : q4.x, b0, s0);
              split((s4 & 1) ? q4.w : q4.y, b1, s1);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_tf32(acc[mt][nt], af[mt], b0, b1);
                mma_tf32(acc[mt][nt], af[mt], s0, s1);
              }
            }
          }
        } else {
          // columns 16 kg .. + 15: lane t holds 16 kg + 4t .. + 3 (chunk
          // 4 kg + t of the doc and the query box); mma k-step s2 takes
          // 4t + 2 s2 and 4t + 2 s2 + 1; 3xTF32
          float4 ar[2][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              ar[mt][h] = *reinterpret_cast<const float4*>(
                  A + swz(32 * mh + 16 * mt + 8 * h + frag_row(g),
                          4 * kg + t));
          float4 bq[4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            bq[nt] = *reinterpret_cast<const float4*>(
                B + swz(8 * nt + qn(g), 4 * kg + t));
#pragma unroll
          for (int s2 = 0; s2 < 2; ++s2) {
            uint32_t ab[2][4], as[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              split(s2 ? ar[mt][0].z : ar[mt][0].x, ab[mt][0], as[mt][0]);
              split(s2 ? ar[mt][1].z : ar[mt][1].x, ab[mt][1], as[mt][1]);
              split(s2 ? ar[mt][0].w : ar[mt][0].y, ab[mt][2], as[mt][2]);
              split(s2 ? ar[mt][1].w : ar[mt][1].y, ab[mt][3], as[mt][3]);
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              uint32_t b0, s0, b1, s1;
              split(s2 ? bq[nt].z : bq[nt].x, b0, s0);
              split(s2 ? bq[nt].w : bq[nt].y, b1, s1);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_tf32(acc[mt][nt], ab[mt], b0, b1);
                mma_tf32(acc[mt][nt], ab[mt], s0, s1);
                mma_tf32(acc[mt][nt], as[mt], b0, b1);
              }
            }
          }
        }
        if (++unflushed == kFlush) flush();
      };

      // query tile qt done: the two column halves' sums added (kg 0 +
      // kg 1), the max over the block's valid rows of each token into its
      // slot, and the sums start again from zero
      auto epilogue = [&](long long qt) {
        flush();
        if (kg == 1) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                xch[(((mt * 4 + nt) * 4 + e) * 2 + mh) * 32 + lane] =
                    tot[mt][nt][e];
        }
        consumers_sync();
        if (kg == 0) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            // C's e = 0, 1: fragment row g, columns 2t, 2t + 1; e = 2, 3:
            // row g + 8
            float m[2] = {kNegInf, kNegInf};
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float v =
                    tot[mt][nt][e] +
                    xch[(((mt * 4 + nt) * 4 + e) * 2 + mh) * 32 + lane];
                if (row_ok[32 * mh + 16 * mt + 8 * (e >> 1) + frag_row(g)])
                  m[e & 1] = fmaxf(m[e & 1], v);
              }
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
              m[0] = fmaxf(m[0], __shfl_xor_sync(0xffffffffu, m[0], off));
              m[1] = fmaxf(m[1], __shfl_xor_sync(0xffffffffu, m[1], off));
            }
            if (g == 0) {
              red[mh][8 * nt + qn(2 * t)] = m[0];
              red[mh][8 * nt + qn(2 * t + 1)] = m[1];
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) tot[mt][nt][e] = 0.f;
        consumers_sync();
        const long long tok = qt * kTileQ + tid;
        if (tid < kTileQ && tok < n_tok)
          atomicMax(
              a.slots + static_cast<size_t>(c) * n_tok + tok,
              order_key(fmaxf(fmaxf(red[0][tid], red[1][tid]), kNegInf)));
        consumers_sync();  // red is written again at the next tile's end
      };

      int s = 0, sl = 0;
      uint32_t phase = 0;
      long long qt = 0;
      for (long long i = 0; i < items; ++i) {
        mbar_wait(full + s, phase);
        compute(s);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
        if (++sl == n_slices) {
          epilogue(qt);
          sl = 0;
          ++qt;
        }
      }
    }
  }

  // the last block of candidate c adds each query's maxima
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(a.tickets + c, 1) == a.row_tiles - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float* buf = reinterpret_cast<float*>(dyn);  // the ring is idle now
  const float skip = __uint_as_float(0xff800000u);  // -inf: a masked token
  const int per = min(kThreads, max(1, kSumChunk / a.LQ));  // queries a round
  const int span = min(a.LQ, kSumChunk);  // a query's tokens a round
  for (int q0 = 0; q0 < a.Q; q0 += per) {
    const int nq = min(per, a.Q - q0);
    float sum = 0.f, carry = 0.f;  // thread i < nq adds query q0 + i
    for (int l0 = 0; l0 < a.LQ; l0 += span) {
      const int nl = min(span, a.LQ - l0);
      for (int e = tid; e < nq * nl; e += kThreads) {
        const int i = e / nl;
        const long long tok =
            static_cast<long long>(q0 + i) * a.LQ + l0 + (e - i * nl);
        const unsigned key =
            atomicExch(a.slots + static_cast<size_t>(c) * n_tok + tok, 0u);
        buf[e] = a.q_mask[tok] ? from_key(key) : skip;
      }
      __syncthreads();
      if (tid < nq) {
        for (int l = 0; l < nl; ++l) {
          const float v = buf[tid * nl + l];
          if (v != skip) kahan_add(v, sum, carry);
        }
      }
      __syncthreads();
    }
    if (tid < nq) a.out[static_cast<size_t>(q0 + tid) * a.C + c] = sum;
  }
  if (tid == 0) a.tickets[c] = 0;
}

// ---- host side ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// -lcuda at build time)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a [rows, D] row-major matrix read in boxes of box_rows rows x
// 128 bytes, 128-byte swizzled, zeros outside. The row stride must be a
// multiple of 16 bytes and the pointer 16-byte aligned.
cudaError_t box_map(CUtensorMap* map, CUtensorMapDataType type, int itemsize,
                    const void* ptr, long long rows, int D, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * itemsize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kRowBytes / itemsize),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr int kMaxDevices = 64;

// Raises maxsim_kernel<T>'s dynamic shared memory limit on the current
// device to at least smem bytes; the limit only grows, so a rerank of the
// same shape sets it once. Too much for the card returns the error, and
// clears it, so that the next launch of another library does not see it.
template <typename T>
cudaError_t reserve_smem(int smem) {
  static int granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(maxsim_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (dev < kMaxDevices) granted[dev] = smem;
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch(Args a, CUtensorMapDataType type, cudaStream_t st) {
  constexpr int size = static_cast<int>(sizeof(T));
  CUtensorMap map_d = {}, map_q = {};
  a.tma_d = a.D * size % 16 == 0 && aligned16(a.dv);
  a.tma_q = a.D % 4 == 0 && aligned16(a.qv);
  cudaError_t err = cudaSuccess;
  if (a.tma_d)
    err = box_map(&map_d, type, size, a.dv,
                  static_cast<long long>(a.C) * a.LD, a.D, kRows);
  if (err == cudaSuccess && a.tma_q)
    err = box_map(&map_q, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.qv,
                  static_cast<long long>(a.Q) * a.LQ, a.D, kTileQ);
  if (err != cudaSuccess) return err;
  const int smem = smem_bytes<T>(a.stages);
  err = reserve_smem<T>(smem);
  if (err != cudaSuccess) return err;
  maxsim_kernel<T><<<a.C * a.row_tiles, kThreads, smem, st>>>(map_d, map_q,
                                                             a);
  return cudaGetLastError();
}

int smem_of(int dtype, int stages) {
  switch (dtype) {
    case 0: return smem_bytes<float>(stages);
    case 1: return smem_bytes<__half>(stages);
    case 2: return smem_bytes<__nv_bfloat16>(stages);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// dtype of dv: 0 f32, 1 f16, 2 bf16. qv [Q, LQ, D] f32; q_mask [Q, LQ] and
// d_mask [C, LD] bool (one byte each); dv [C, LD, D]; all contiguous. The
// plan (ops/maxsim.py::maxsim_plan): row_tile 64, query_tile 32, stages
// 2-6. slots [C, Q * LQ] and tickets [C] (32-bit) are a workspace that
// must be zero before the first call; each call leaves it zero. out [Q, C]
// f32. One launch (`maxsim_launches`). Returns a cudaError_t.
int maxsim(int dtype, const float* qv, const uint8_t* q_mask, const void* dv,
           const uint8_t* d_mask, int Q, int LQ, int C, int LD, int D,
           int row_tile, int query_tile, int stages, unsigned* slots,
           int* tickets, float* out, void* stream) {
  if (Q < 1 || LQ < 1 || C < 1 || LD < 1 || D < 1 || row_tile != kRows ||
      query_tile != kTileQ || stages < kMinStages || stages > kMaxStages)
    return cudaErrorInvalidValue;
  const long long row_tiles = (LD + kRows - 1) / kRows;
  if (C * row_tiles > INT_MAX ||
      static_cast<long long>(Q) * LQ + kTileQ > INT_MAX ||
      static_cast<long long>(C) * LD + kRows > INT_MAX)
    return cudaErrorInvalidValue;  // TMA's coordinates are 32-bit
  Args a;
  a.qv = qv;
  a.q_mask = q_mask;
  a.dv = dv;
  a.d_mask = d_mask;
  a.Q = Q;
  a.LQ = LQ;
  a.C = C;
  a.LD = LD;
  a.D = D;
  a.row_tiles = static_cast<int>(row_tiles);
  a.stages = stages;
  a.slots = slots;
  a.tickets = tickets;
  a.out = out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, st);
    case 1: return launch<__half>(a, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st);
    case 2:
      return launch<__nv_bfloat16>(a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st);
    default: return cudaErrorInvalidValue;
  }
}

// the plan's dynamic shared bytes, as the launch asks for them (-1 for an
// unknown dtype)
int maxsim_smem(int dtype, int stages) { return smem_of(dtype, stages); }

// kernels one call of `maxsim` launches
int maxsim_launches() { return kLaunches; }

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
