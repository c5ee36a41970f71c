// Flash-attention forward for Hopper (sm_90a): non-causal attention with keys
// masked by a per-batch length, online softmax in f32, optional logsumexp,
// both products on the tensor cores.
//
// Replaces the Pallas TPU kernels
//   rag_dpo_tpu/ops/flash_attention_bwd.py::_fwd_kernel (via _fwd_with_stats)
//   rag_dpo_tpu/ops/flash_attention.py::_flash_kernel (same math, no lse)
// and keeps their numerics: scores, softmax and accumulators in f32 whatever
// the input type, running max clamped at -1e20 and the denominator at 1e-30,
// so a row whose keys are all masked outputs 0 and lse = -1e20.
//
// Layout: q, k, v, out are [B, H, S, Dh] contiguous, any Dh up to 512;
// lengths [B] int32; lse [B, H, S] f32 (the wrapper views it as
// [B, H, S, 1]). One block of 4 warps owns one (b*h, query tile) and walks
// the key tiles below min(lengths[b], S): tiles at or past it would add
// exp(-1e30 - m) = 0 and are skipped. The ragged edges of S and Dh are
// zero-filled in the loads; nothing is padded in memory. Instances exist
// for padded widths DHP of 16, 32, 64, 128, 256 and 512; zero columns change
// no score and no output, and k-steps and output columns wholly past the
// true Dh are skipped.
//
// The products run on mma.sync (sm_80's warp-level tensor-core products,
// which sm_90a keeps; the split, the products, cp.async and the tile loader
// are in mma_sync.cuh, shared with flash_bwd.cu). f32 inputs keep f32
// accuracy by 3xTF32: x = big + small with big rounded to TF32 (on the
// ALU) and small = x - big exact;
// each 8-deep product is big.small' + small.big' + big.big', three m16n8k8
// TF32 products accumulated in f32. The tensor core reads the top 19 bits
// of small (it ignores the low 13, as CUTLASS's 3xTF32 relies on), so a
// product errs ~2^-21 of its size, the dropped small.small' ~2^-22.
// bf16 inputs take Q.K^T on m16n8k16, exact in f32, and P.V as one 16-deep
// bf16 product of P = hi + lo (16 bits) against V twice: P keeps f32
// accuracy to 2^-17 (C-5).
//
// The softmax runs on the score fragments in registers: a thread holds
// keys (2t, 2t+1) of rows g and g+8 of each 8-key slice, and the row max and
// sum take two quad shuffles. P never goes to shared memory: the bf16 A
// fragment wants exactly those pairs; the TF32 one wants keys (t, t+4), so
// its k order is taken as (2t, 2t+1) and V's rows are read in that order
// too (P.V does not depend on the order of the keys). Q.K^T takes its d
// order the same way, so a thread's Q and K pairs come in 8-byte loads.
//
// Tiles: the query tile once, then K and V in a ring of two tiles filled
// by 16-byte cp.async (a zero fill past S and Dh), so tile
// t+1 loads while tile t is multiplied. Q and K rows are padded by 32 bytes
// (f32; 16 for bf16) and V rows by 16, so the fragment loads of a warp fall
// in distinct banks. Up to DHP 64 a warp holds two 16-row m-tiles (a block
// 128 query rows), so each K and V fragment it splits serves both m-tiles,
// and key tiles are 64 rows: 108,544 bytes of shared memory (f32, DHP 64),
// two blocks an SM, 8 warps. Wider heads hold one m-tile (64 query rows),
// key tiles of 32 rows up to DHP 256 and 16 at 512; past DHP 128 the output
// columns go in passes of 128, each recomputing the scores (the same P
// bits, so exact) to bound the accumulator registers.
//
// At DHP 64 a warp spends most of its instructions on the split (round,
// subtract) of the K and V fragments it reads and on the softmax, not on
// the products. The result is deterministic: no atomics, the same bits run
// to run.

#include <math.h>

#include "mma_sync.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;  // the K/V ring
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int DHP>
struct Cfg {
  // m-tiles a warp holds: a V or K fragment split once serves each of them
  static constexpr int kMT = DHP <= 64 ? 2 : 1;
  static constexpr int kBlockQ = 16 * kMT * kWarps;  // query rows of a block
  static constexpr int kBlockK = DHP <= 64 ? 64 : DHP <= 256 ? 32 : 16;
  static constexpr int kDV = DHP <= 128 ? DHP : 128;  // output columns a pass
  // row strides: Q and K rows padded by 8 elements (32 bytes of f32, for
  // 8-byte fragment loads; 16 of bf16), V rows by 16 bytes; no fragment
  // load conflicts
  static constexpr int kLdQK = DHP + 8;
  static constexpr int kLdV = kDV + 16 / static_cast<int>(sizeof(T));
  static constexpr size_t kSmem =
      sizeof(T) * (static_cast<size_t>(kBlockQ) * kLdQK +
                   static_cast<size_t>(kStages) * kBlockK * (kLdQK + kLdV));
};

// The warp's 16 Q rows of one m-tile as A fragments, a k-step of 8 columns
// at a time, read from shared memory at each use. f32: the TF32 fragments
// of the big and the small parts, the columns in the order 2t, 2t + 1
// (fragment columns t, t + 4). bf16: a 16-column step, the fragment as it
// is.
template <typename T, int DHP>
__device__ __forceinline__ void q_frags(const T* qs, int c0, int g, int t,
                                        uint32_t (&b)[4], uint32_t (&x)[4]) {
  constexpr int LD = Cfg<T, DHP>::kLdQK;
  if constexpr (sizeof(T) == 4) {
    const float* q = reinterpret_cast<const float*>(qs) + c0 + 2 * t;
    const float2 r0 = *reinterpret_cast<const float2*>(q + g * LD);
    const float2 r1 = *reinterpret_cast<const float2*>(q + (g + 8) * LD);
    split(r0.x, b[0], x[0]);
    split(r1.x, b[1], x[1]);
    split(r0.y, b[2], x[2]);
    split(r1.y, b[3], x[3]);
  } else {
    const T* q = qs + c0 + 2 * t;
    b[0] = *reinterpret_cast<const uint32_t*>(q + g * LD);
    b[1] = *reinterpret_cast<const uint32_t*>(q + (g + 8) * LD);
    b[2] = *reinterpret_cast<const uint32_t*>(q + g * LD + 8);
    b[3] = *reinterpret_cast<const uint32_t*>(q + (g + 8) * LD + 8);
  }
}

// s[m][n] += Q[16 rows of m-tile m] . K[8 keys of slice n]^T over the first
// Dh columns
template <typename T, int DHP>
__device__ __forceinline__ void scores(
    float (&s)[Cfg<T, DHP>::kMT][Cfg<T, DHP>::kBlockK / 8][4], const T* qs,
    const T* ks, int Dh, int g, int t) {
  using C = Cfg<T, DHP>;
  constexpr int MT = C::kMT, NT = C::kBlockK / 8;
  constexpr int LD = C::kLdQK;
  if constexpr (sizeof(T) == 4) {
    // per 8 columns, 3xTF32: the cross terms big.small' and small.big',
    // then big.big', each on m16n8k8 TF32
    const float* k = reinterpret_cast<const float*>(ks);
#pragma unroll
    for (int c0 = 0; c0 < DHP; c0 += 8) {
      if (c0 >= Dh) break;  // uniform: the columns past Dh are zeros
      uint32_t ab[MT][4], ax[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        q_frags<T, DHP>(qs + m * 16 * LD, c0, g, t, ab[m], ax[m]);
      // the B fragments of every key slice, then each kind of product over
      // all slices, so no product waits on the one before it
      uint32_t b0[NT], b1[NT], x0[NT], x1[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 kv =
            *reinterpret_cast<const float2*>(k + (n * 8 + g) * LD + c0 + 2 * t);
        split(kv.x, b0[n], x0[n]);
        split(kv.y, b1[n], x1[n]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32(s[m][n], ab[m], x0[n], x1[n]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32(s[m][n], ax[m], b0[n], b1[n]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32(s[m][n], ab[m], b0[n], b1[n]);
    }
  } else {
#pragma unroll
    for (int c0 = 0; c0 < DHP; c0 += 16) {
      if (c0 >= Dh) break;
      uint32_t a[MT][4], unused[4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        q_frags<T, DHP>(qs + m * 16 * LD, c0, g, t, a[m], unused);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const T* kr = ks + (n * 8 + g) * LD + c0 + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_bf16(s[m][n], a[m], b0, b1);
      }
    }
  }
}

// o[m][nv] += P[16 rows of m-tile m, the tile's keys] . V[keys, 8 columns of
// slice nv] for the slices below Dh - col0. The score fragment p[m][n] of
// key slice n holds keys 2t and 2t + 1 of rows g and g + 8. f32: its split
// parts are A fragments of m16n8k8 read as columns (2t, 2t+1) -> (t, t+4),
// so V's rows go in the order 2t, 2t + 1; 3xTF32 as in `scores`. bf16:
// P = hi + lo in bf16 (16 bits) against V twice, one 16-deep bf16 product;
// V is exact.
template <typename T, int DHP>
__device__ __forceinline__ void accumulate(
    float (&o)[Cfg<T, DHP>::kMT][Cfg<T, DHP>::kDV / 8][4],
    const float (&p)[Cfg<T, DHP>::kMT][Cfg<T, DHP>::kBlockK / 8][4],
    const T* vs, int cols, int g, int t) {
  using C = Cfg<T, DHP>;
  constexpr int MT = C::kMT, NT = C::kBlockK / 8;
  constexpr int LD = C::kLdV;
  constexpr int G = C::kDV / 8 < 8 ? C::kDV / 8 : 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t ab[MT][4], ax[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if constexpr (sizeof(T) == 4) {
        // the TF32 fragment wants (row g: 2t, row g+8: 2t, g: 2t+1, g+8: 2t+1)
        split(p[m][n][0], ab[m][0], ax[m][0]);
        split(p[m][n][2], ab[m][1], ax[m][1]);
        split(p[m][n][1], ab[m][2], ax[m][2]);
        split(p[m][n][3], ab[m][3], ax[m][3]);
      } else {
        float hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[e] = __uint_as_float((__float_as_uint(p[m][n][e]) + 0x8000u) &
                                  0xffff0000u);
          lo[e] = p[m][n][e] - hi[e];
        }
        ax[m][0] = bf16x2(hi[0], hi[1]);
        ax[m][1] = bf16x2(hi[2], hi[3]);
        ax[m][2] = bf16x2(lo[0], lo[1]);
        ax[m][3] = bf16x2(lo[2], lo[3]);
      }
    }
    const T* v0 = vs + (n * 8 + 2 * t) * LD + g;
    // the output slices in groups of 8 (DV > 64 takes two): each group's
    // B fragments, then each kind of product over the group
#pragma unroll
    for (int nv0 = 0; nv0 < C::kDV / 8; nv0 += G) {
      if (nv0 * 8 >= cols) break;  // uniform: output columns past Dh
      uint32_t b0[G], b1[G], x0[G], x1[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if constexpr (sizeof(T) == 4) {
          split(v0[(nv0 + j) * 8], b0[j], x0[j]);
          split(v0[LD + (nv0 + j) * 8], b1[j], x1[j]);
        } else {  // keys 2t, 2t + 1 of the slice, for P's hi and lo halves
          const uint16_t* v16 = reinterpret_cast<const uint16_t*>(v0);
          x0[j] = x1[j] = static_cast<uint32_t>(v16[(nv0 + j) * 8]) |
                          static_cast<uint32_t>(v16[LD + (nv0 + j) * 8]) << 16;
        }
      }
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < G; ++j)
            mma_tf32(o[m][nv0 + j], ab[m], x0[j], x1[j]);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < G; ++j)
            mma_tf32(o[m][nv0 + j], ax[m], b0[j], b1[j]);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < G; ++j)
            mma_tf32(o[m][nv0 + j], ab[m], b0[j], b1[j]);
      } else {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < G; ++j)
            mma_bf16(o[m][nv0 + j], ax[m], x0[j], x1[j]);
      }
    }
  }
}

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 T* __restrict__ out, float* __restrict__ lse, int H, int S,
                 int Dh, int n_qtiles, float scale, bool vec) {
  using C = Cfg<T, DHP>;
  constexpr int MT = C::kMT, BQ = C::kBlockQ, BK = C::kBlockK, NT = BK / 8;
  constexpr int DV = C::kDV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);     // [BQ][kLdQK]
  T* ks = qs + BQ * C::kLdQK;                  // [kStages][BK][kLdQK]
  T* vs = ks + kStages * BK * C::kLdQK;        // [kStages][BK][kLdV]

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * BQ;
  const int b = bh / H;
  const size_t base = static_cast<size_t>(bh) * S * Dh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int len = max(0, min(lengths[b], S));
  const int n_ktiles = (len + BK - 1) / BK;
  const int r0 = q0 + warp * 16 * MT;  // the warp's first query row
  const bool live = r0 < S;            // warp-uniform: any of its rows in S

  load_tile<kThreads, T, BQ, DHP, C::kLdQK>(qs, q + base, q0, 0, S, Dh, vec);
  cp_async_commit();

  for (int col0 = 0; col0 < Dh; col0 += DV) {
    float o[MT][DV / 8][4];
    // rows g and g + 8 of each m-tile: running max (== the reference's
    // clamp applied to its -1e30 start) and this thread's share of the
    // denominator
    float mr[MT][2], lr[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        o[m][j][0] = o[m][j][1] = o[m][j][2] = o[m][j][3] = 0.f;
      mr[m][0] = mr[m][1] = -1e20f;
      lr[m][0] = lr[m][1] = 0.f;
    }

    if (n_ktiles > 0) {
      load_tile<kThreads, T, BK, DHP, C::kLdQK>(ks, k + base, 0, 0, S, Dh, vec);
      load_tile<kThreads, T, BK, DV, C::kLdV>(vs, v + base, 0, col0, S, Dh, vec);
      cp_async_commit();
    }
    for (int kt = 0; kt < n_ktiles; ++kt) {
      const int slot = kt % kStages;
      // tile kt + 1 goes into the slot tile kt - 1 left
      const int ahead = kt + kStages - 1;
      if (ahead < n_ktiles) {
        const int nslot = ahead % kStages;
        load_tile<kThreads, T, BK, DHP, C::kLdQK>(ks + nslot * BK * C::kLdQK, k + base,
                                        ahead * BK, 0, S, Dh, vec);
        load_tile<kThreads, T, BK, DV, C::kLdV>(vs + nslot * BK * C::kLdV, v + base,
                                      ahead * BK, col0, S, Dh, vec);
      }
      cp_async_commit();  // (an empty group past the last tile)
      // one group follows tile kt's: waiting for all but it lands tile kt
      cp_async_wait<kStages - 1>();
      __syncthreads();

      if (live) {
        float s[MT][NT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
            s[m][n][0] = s[m][n][1] = s[m][n][2] = s[m][n][3] = 0.f;
        scores<T, DHP>(s, qs + warp * MT * 16 * C::kLdQK,
                       ks + slot * BK * C::kLdQK, Dh, g, t);

        const int k0 = kt * BK;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + n * 8 + 2 * t + (e & 1);
              s[m][n][e] = col < len ? s[m][n][e] * scale : kNegInf;
              if (e < 2) mx0 = fmaxf(mx0, s[m][n][e]);
              else mx1 = fmaxf(mx1, s[m][n][e]);
            }
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
          }
          const float n0 = fmaxf(fmaxf(mr[m][0], mx0), -1e20f);
          const float n1 = fmaxf(fmaxf(mr[m][1], mx1), -1e20f);
          const float a0 = exp2f((mr[m][0] - n0) * kLog2e);
          const float a1 = exp2f((mr[m][1] - n1) * kLog2e);
          mr[m][0] = n0;
          mr[m][1] = n1;
          float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            s[m][n][0] = exp2f((s[m][n][0] - n0) * kLog2e);
            s[m][n][1] = exp2f((s[m][n][1] - n0) * kLog2e);
            s[m][n][2] = exp2f((s[m][n][2] - n1) * kLog2e);
            s[m][n][3] = exp2f((s[m][n][3] - n1) * kLog2e);
            ps0 += s[m][n][0] + s[m][n][1];
            ps1 += s[m][n][2] + s[m][n][3];
          }
          lr[m][0] = lr[m][0] * a0 + ps0;
          lr[m][1] = lr[m][1] * a1 + ps1;
#pragma unroll
          for (int j = 0; j < DV / 8; ++j) {
            o[m][j][0] *= a0;
            o[m][j][1] *= a0;
            o[m][j][2] *= a1;
            o[m][j][3] *= a1;
          }
        }
        accumulate<T, DHP>(o, s, vs + slot * BK * C::kLdV, Dh - col0, g, t);
      }
      __syncthreads();  // this slot is refilled by the next step
    }
    cp_async_wait<0>();

#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float l = lr[m][h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float l_row = fmaxf(l, 1e-30f);
        const int row = r0 + m * 16 + g + 8 * h;
        if (row >= S) continue;
        T* orow = out + base + static_cast<size_t>(row) * Dh;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = col0 + j * 8 + 2 * t + e;
            if (col < Dh) orow[col] = from_f32<T>(o[m][j][2 * h + e] / l_row);
          }
        if (lse != nullptr && t == 0 && col0 == 0)
          lse[static_cast<size_t>(bh) * S + row] = mr[m][h] + logf(l_row);
      }
  }
  cp_async_wait<0>();  // Dh = 0 or no key tile: the Q group may be in flight
}

template <typename T, int DHP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* lse, int B, int H,
                   int S, int Dh, float scale, cudaStream_t stream) {
  constexpr size_t smem = Cfg<T, DHP>::kSmem;
  auto kernel = flash_fwd_kernel<T, DHP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_qtiles = (S + Cfg<T, DHP>::kBlockQ - 1) / Cfg<T, DHP>::kBlockQ;
  const long long n_blocks = static_cast<long long>(n_qtiles) * B * H;
  if (n_blocks == 0) return cudaSuccess;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const bool vec = (Dh * sizeof(T)) % 16 == 0 && addr % 16 == 0;
  kernel<<<static_cast<unsigned>(n_blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), lse, H, S, Dh,
      n_qtiles, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* lengths, void* out, float* lse, int B, int H,
                     int S, int Dh, float scale, cudaStream_t stream) {
#define K1_LAUNCH(DHP) \
  return launch<T, DHP>(q, k, v, lengths, out, lse, B, H, S, Dh, scale, stream)
  if (Dh < 1) return cudaErrorInvalidValue;
  if (Dh <= 16) K1_LAUNCH(16);
  if (Dh <= 32) K1_LAUNCH(32);
  if (Dh <= 64) K1_LAUNCH(64);
  if (Dh <= 128) K1_LAUNCH(128);
  if (Dh <= 256) K1_LAUNCH(256);
  if (Dh <= 512) K1_LAUNCH(512);
#undef K1_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. 1 <= Dh <= 512. lse may be null.
// Returns a cudaError_t.
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

// Shared bytes a block of the instance for (dtype, Dh) takes; the cuda tests
// and the smoke's record read it.
long long flash_fwd_smem(int dtype, int Dh) {
  const int dhp = Dh <= 16 ? 16 : Dh <= 32 ? 32 : Dh <= 64 ? 64
                : Dh <= 128 ? 128 : Dh <= 256 ? 256 : 512;
#define K1_SMEM(T)                                                        \
  switch (dhp) {                                                          \
    case 16: return static_cast<long long>(Cfg<T, 16>::kSmem);            \
    case 32: return static_cast<long long>(Cfg<T, 32>::kSmem);            \
    case 64: return static_cast<long long>(Cfg<T, 64>::kSmem);            \
    case 128: return static_cast<long long>(Cfg<T, 128>::kSmem);          \
    case 256: return static_cast<long long>(Cfg<T, 256>::kSmem);          \
    default: return static_cast<long long>(Cfg<T, 512>::kSmem);           \
  }
  if (dtype == 0) { K1_SMEM(float) }
  K1_SMEM(__nv_bfloat16)
#undef K1_SMEM
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
