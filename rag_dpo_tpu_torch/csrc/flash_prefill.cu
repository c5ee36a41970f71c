// Causal, grouped-query flash attention for a decoder's prompt on Hopper
// (sm_90a): the query rows of a prefill or a prefill segment against the
// first kv_len rows of the K/V cache, online softmax in f32, both products
// on the tensor cores.
//
// Replaces no TPU kernel: the JAX decoder computes this attention with XLA
// einsums (rag_dpo_tpu/models/decoder.py, DecoderAttention), and the port
// ran the same einsums on the card in blocks of query rows, in f32 on the
// CUDA cores, every query row against every key up to kv_len with the
// causal half and the padding rows computed and then masked. Its plain
// twin is ops/causal_attention.py::causal_attention_plain.
//
// Numerics (the decoder's "attention and softmax in f32"): bf16 Q.K^T on
// m16n8k16, exact in f32; scores, running max (clamped at -1e20) and the
// denominator (clamped at 1e-30) in f32; P.V with P carried at 24 bits as
// three bf16 pieces, hi + mid + lo = P exactly, each against V (exact in
// bf16) on m16n8k16. f32 inputs take 3xTF32 for both products, as
// flash_fwd.cu does. So the only difference from the twin is the order of
// the f32 sums (and exp2f for exp). The output is rounded once to the
// input type.
//
// Layout: q and out are [B, S, nh, Dh] contiguous; k and v are the cache's
// rows [B, >= kv_len, nkv, Dh] with a batch stride and a row stride in
// elements (the last two dimensions contiguous); pos [B, S] int32 is each
// query row's position; counts [B] int32 (or null: S) is how many leading
// query rows a batch row writes to the cache. Query row p of head h sees
// key j iff j <= pos[b, p] and j < kv_len.
//
// Blocks: the nh / nkv query heads that share a KV head (the group G) are
// served together. A block owns one (b, KV head) and 64 consecutive rows of
// its [S, G] (position, head) sequence, 16 a warp: 64 / G positions of all
// G heads, so each K/V tile brought to shared memory feeds every head of
// the group. The block walks the key tiles below the largest key its valid
// rows see (min(max pos + 1, kv_len)): tiles wholly past the causal edge
// are skipped, not masked, and only the tiles a warp's rows do not wholly
// see are masked. A block whose first position is at or past counts[b]
// (padding rows: their K/V rows are zeroed before the cache write, and no
// valid row sees them) writes zeros and returns. Blocks are numbered so the
// last query tiles, which walk the most keys, launch first.
//
// Bound: the causal products, 4 Dh nh Σ_p (pos_p + 1) at the bf16 tensor
// peak (P.V run three times, so the mma work is twice the count), or
// the bytes of q, k, v and out at 3.35 TB/s. Tiles: the Q tile once, the
// bf16 fragments held in registers; K and V in a two-stage ring filled by
// 16-byte cp.async, read by ldmatrix (V transposed); rows padded by 16
// bytes, so the fragment loads are free of bank conflicts. The softmax
// runs on the score fragments in registers; P never goes to shared memory.
// Instances for padded widths 32, 64 and 128; any Dh up to 128 is
// zero-filled in the loads. Deterministic: no atomics on the data.

#include <math.h>

#include "mma_sync.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // (position, head) rows of a block
constexpr int kStages = 2;          // the K/V ring
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int DHP>
struct Cfg {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kBlockK = kBf16 || DHP <= 64 ? 64 : 32;
  // Q and K rows padded by 8 elements (16 bytes of bf16 for ldmatrix, 32
  // of f32 for 8-byte fragment loads), V rows by 16 bytes
  static constexpr int kLdQK = DHP + 8;
  static constexpr int kLdV = DHP + 16 / static_cast<int>(sizeof(T));
  static constexpr size_t kSmem =
      sizeof(T) * (static_cast<size_t>(kRows) * kLdQK +
                   static_cast<size_t>(kStages) * kBlockK * (kLdQK + kLdV));
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// x rounded to bf16 (to nearest, ties away), as an f32
__device__ __forceinline__ float bf16_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x8000u) & 0xffff0000u);
}

// (a, b) with a in the low half: the high halves of two f32 that are bf16
// values already
__device__ __forceinline__ uint32_t pack_exact(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// x = hi + mid + lo exactly for the pair (x0, x1): each residual is exact
// in f32, and a 24-bit significand leaves at most 8 bits for lo
__device__ __forceinline__ void three_pieces(float x0, float x1, uint32_t& hi,
                                             uint32_t& mid, uint32_t& lo) {
  const float h0 = bf16_round(x0), h1 = bf16_round(x1);
  const float r0 = x0 - h0, r1 = x1 - h1;
  const float m0 = bf16_round(r0), m1 = bf16_round(r1);
  hi = pack_exact(h0, h1);
  mid = pack_exact(m0, m1);
  lo = bf16x2(r0 - m0, r1 - m1);
}

// ROWS rows of COLS columns into a tile of row stride LD; row_ptr(r) is row
// r's first element or null past the rows; zeros past Dh and the rows.
// `vec`: every row pointer and Dh are whole 16-byte chunks, so each chunk
// goes by cp.async; otherwise element by element (synchronously).
template <typename T, int ROWS, int COLS, int LD, typename RowPtr>
__device__ __forceinline__ void load_rows(T* dst, RowPtr row_ptr,
                                          const T* any, int Dh, bool vec) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  if (vec) {
    constexpr int kChunks = COLS / kPer;
    for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
      const int r = c / kChunks, cc = (c - r * kChunks) * kPer;
      const T* row = row_ptr(r);
      const bool ok = row != nullptr && cc < Dh;
      cp_async16(dst + r * LD + cc, ok ? row + cc : any, ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += kThreads) {
      const int r = e / COLS, cc = e - r * COLS;
      const T* row = row_ptr(r);
      dst[r * LD + cc] =
          row != nullptr && cc < Dh ? row[cc] : from_f32<T>(0.f);
    }
  }
}

// s[n] += Q[the warp's 16 rows] . K[8 keys of slice n]^T over the first Dh
// columns. bf16: the Q fragments held in registers, K's B fragments by
// ldmatrix, two key slices an ldmatrix. f32: 3xTF32 on m16n8k8 as
// flash_fwd.cu's `scores`, Q read from shared memory, the d order of a
// thread's pairs taken as (2t, 2t + 1) so its loads are 8 bytes.
template <typename T, int DHP>
__device__ __forceinline__ void scores(
    float (&s)[Cfg<T, DHP>::kBlockK / 8][4],
    const uint32_t (&qf)[Cfg<T, DHP>::kBf16 ? DHP / 16 : 1][4], const T* qs,
    const T* ks, int Dh, int lane) {
  using C = Cfg<T, DHP>;
  constexpr int NT = C::kBlockK / 8, LD = C::kLdQK;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (C::kBf16) {
    // the lane's ldmatrix row: key (lane & 7) + 8 (lane >> 4), columns from
    // 8 ((lane >> 3) & 1): matrices (b0, b1) of slice n, then of n + 1
    const T* base =
        ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3);
#pragma unroll
    for (int c = 0; c < DHP / 16; ++c) {
      if (c * 16 >= Dh) break;  // uniform: the columns past Dh are zeros
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, base + n * 8 * LD + c * 16);
        mma_bf16(s[n], qf[c], b[0], b[1]);
        mma_bf16(s[n + 1], qf[c], b[2], b[3]);
      }
    }
  } else {
    const float* q = reinterpret_cast<const float*>(qs);
    const float* k = reinterpret_cast<const float*>(ks);
#pragma unroll
    for (int c0 = 0; c0 < DHP; c0 += 8) {
      if (c0 >= Dh) break;
      uint32_t ab[4], ax[4];
      const float2 r0 = *reinterpret_cast<const float2*>(q + g * LD + c0 + 2 * t);
      const float2 r1 =
          *reinterpret_cast<const float2*>(q + (g + 8) * LD + c0 + 2 * t);
      split(r0.x, ab[0], ax[0]);
      split(r1.x, ab[1], ax[1]);
      split(r0.y, ab[2], ax[2]);
      split(r1.y, ab[3], ax[3]);
      uint32_t b0[NT], b1[NT], x0[NT], x1[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 kv =
            *reinterpret_cast<const float2*>(k + (n * 8 + g) * LD + c0 + 2 * t);
        split(kv.x, b0[n], x0[n]);
        split(kv.y, b1[n], x1[n]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_tf32(s[n], ab, x0[n], x1[n]);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_tf32(s[n], ax, b0[n], b1[n]);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_tf32(s[n], ab, b0[n], b1[n]);
    }
  }
}

// o[nv] += P[the warp's 16 rows, the tile's keys] . V[keys, 8 columns of
// slice nv] for the slices below Dh. The score fragment p[n] holds keys 2t
// and 2t + 1 of rows g and g + 8 of key slice n. bf16: two slices make the
// A fragment of one 16-deep product, P in three exact bf16 pieces against
// V's B fragments (ldmatrix.trans, two output slices an ldmatrix); the
// small pieces first. f32: as flash_fwd.cu's `accumulate`, 3xTF32 with the
// k order (2t, 2t + 1) and V's rows read in that order.
template <typename T, int DHP>
__device__ __forceinline__ void accumulate(
    float (&o)[DHP / 8][4], const float (&p)[Cfg<T, DHP>::kBlockK / 8][4],
    const T* vs, int Dh, int lane) {
  using C = Cfg<T, DHP>;
  constexpr int NT = C::kBlockK / 8, LD = C::kLdV;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (C::kBf16) {
    // the lane's ldmatrix row: key (lane & 7) + 8 ((lane >> 3) & 1),
    // columns from 8 (lane >> 4): matrices (b0, b1) of slice nv, then nv + 1
    const T* base =
        vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + ((lane >> 4) << 3);
    constexpr int NV = DHP / 16;  // pairs of output slices
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t pc[3][4];  // lo, mid, hi
      three_pieces(p[2 * j][0], p[2 * j][1], pc[2][0], pc[1][0], pc[0][0]);
      three_pieces(p[2 * j][2], p[2 * j][3], pc[2][1], pc[1][1], pc[0][1]);
      three_pieces(p[2 * j + 1][0], p[2 * j + 1][1], pc[2][2], pc[1][2],
                   pc[0][2]);
      three_pieces(p[2 * j + 1][2], p[2 * j + 1][3], pc[2][3], pc[1][3],
                   pc[0][3]);
      // every B fragment of the 16 keys, then each piece over all output
      // slices: no product waits on the one before it
      uint32_t b[NV][4];
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
        if (nv * 16 < Dh)  // uniform: output columns past Dh
          ldmatrix_x4_trans(b[nv], base + j * 16 * LD + nv * 16);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int nv = 0; nv < NV; ++nv)
          if (nv * 16 < Dh) {
            mma_bf16(o[2 * nv], pc[i], b[nv][0], b[nv][1]);
            mma_bf16(o[2 * nv + 1], pc[i], b[nv][2], b[nv][3]);
          }
    }
  } else {
    constexpr int G = DHP / 8 < 8 ? DHP / 8 : 8;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t ab[4], ax[4];
      // the TF32 fragment wants (row g: 2t, row g+8: 2t, g: 2t+1, g+8: 2t+1)
      split(p[n][0], ab[0], ax[0]);
      split(p[n][2], ab[1], ax[1]);
      split(p[n][1], ab[2], ax[2]);
      split(p[n][3], ab[3], ax[3]);
      const float* v0 =
          reinterpret_cast<const float*>(vs) + (n * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int nv0 = 0; nv0 < DHP / 8; nv0 += G) {
        if (nv0 * 8 >= Dh) break;
        uint32_t b0[G], b1[G], x0[G], x1[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          split(v0[(nv0 + j) * 8], b0[j], x0[j]);
          split(v0[LD + (nv0 + j) * 8], b1[j], x1[j]);
        }
#pragma unroll
        for (int j = 0; j < G; ++j) mma_tf32(o[nv0 + j], ab, x0[j], x1[j]);
#pragma unroll
        for (int j = 0; j < G; ++j) mma_tf32(o[nv0 + j], ax, b0[j], b1[j]);
#pragma unroll
        for (int j = 0; j < G; ++j) mma_tf32(o[nv0 + j], ab, b0[j], b1[j]);
      }
    }
  }
}

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads)
prefill_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    const int* __restrict__ counts, T* __restrict__ out, int B,
                    int S, int nh, int nkv, int Dh, int kv_len,
                    long long kv_bs, long long kv_rs, int n_tiles, float scale,
                    bool vec) {
  using C = Cfg<T, DHP>;
  constexpr int BK = C::kBlockK, NT = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kRows][kLdQK]
  T* ks = qs + kRows * C::kLdQK;            // [kStages][BK][kLdQK]
  T* vs = ks + kStages * BK * C::kLdQK;     // [kStages][BK][kLdV]
  __shared__ int kmax_s;

  const int G = nh / nkv;
  const int bk = blockIdx.x % (B * nkv);
  const int tile = n_tiles - 1 - blockIdx.x / (B * nkv);  // heaviest first
  const int b = bk / nkv, kvh = bk - b * nkv;
  const int R0 = tile * kRows;
  const int n_rows = S * G;
  const int R1 = min(R0 + kRows, n_rows);  // the block's rows [R0, R1)
  const int cnt = counts != nullptr ? min(max(counts[b], 0), S) : S;
  const int* prow = pos + static_cast<size_t>(b) * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // (position, head) row r of the block in q and out
  const size_t head0 = static_cast<size_t>(b) * S * nh + kvh * G;
  auto q_row = [&](int r) -> size_t {
    const int R = R0 + r, p = R / G;
    return (head0 + static_cast<size_t>(p) * nh + (R - p * G)) * Dh;
  };

  if (R0 / G >= cnt) {  // padding rows only
    for (int e = threadIdx.x; e < (R1 - R0) * Dh; e += kThreads) {
      const int r = e / Dh;
      out[q_row(r) + (e - r * Dh)] = from_f32<T>(0.f);
    }
    return;
  }

  // the keys the block's valid rows see: [0, kmax)
  if (threadIdx.x == 0) kmax_s = 0;
  __syncthreads();
  {
    int mine = 0;
    const int p_hi = min((R1 - 1) / G, cnt - 1);
    for (int p = R0 / G + threadIdx.x; p <= p_hi; p += kThreads)
      mine = max(mine, prow[p] + 1);
    if (mine > 0) atomicMax(&kmax_s, mine);
  }
  const size_t kv0 = static_cast<size_t>(b) * kv_bs + kvh * Dh;
  const T* kb = k + kv0;
  const T* vb = v + kv0;
  auto kv_row = [&](const T* base, int k0) {
    return [=](int r) -> const T* {
      return k0 + r < kv_len ? base + (k0 + r) * kv_rs : nullptr;
    };
  };
  load_rows<T, kRows, DHP, C::kLdQK>(
      qs, [&](int r) -> const T* { return R0 + r < R1 ? q + q_row(r) : nullptr; },
      q, Dh, vec);
  cp_async_commit();
  __syncthreads();  // kmax_s
  const int kmax = min(kmax_s, kv_len);
  const int n_kt = (kmax + BK - 1) / BK;
  if (n_kt > 0) {
    load_rows<T, BK, DHP, C::kLdQK>(ks, kv_row(kb, 0), k, Dh, vec);
    load_rows<T, BK, DHP, C::kLdV>(vs, kv_row(vb, 0), v, Dh, vec);
  }
  cp_async_commit();

  // rows g and g + 8 of the warp's m-tile: the keys each sees, [0, lim)
  const int ra = R0 + warp * 16 + g, rb = ra + 8;
  const int lim_a = ra < R1 ? min(prow[ra / G] + 1, kv_len) : 0;
  const int lim_b = rb < R1 ? min(prow[rb / G] + 1, kv_len) : 0;
  int wlim = min(lim_a, lim_b);  // a tile below the warp's least needs no mask
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    wlim = min(wlim, __shfl_xor_sync(0xffffffffu, wlim, off));

  cp_async_wait<1>();  // the Q tile
  __syncthreads();
  const T* qw = qs + warp * 16 * C::kLdQK;
  uint32_t qf[C::kBf16 ? DHP / 16 : 1][4];
  if constexpr (C::kBf16) {
    // the lane's ldmatrix row: (lane & 15), columns from 8 (lane >> 4)
    const T* base = qw + (lane & 15) * C::kLdQK + ((lane >> 4) << 3);
#pragma unroll
    for (int c = 0; c < DHP / 16; ++c) ldmatrix_x4(qf[c], base + c * 16);
  }

  float o[DHP / 8][4];
#pragma unroll
  for (int j = 0; j < DHP / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // running max (== the reference's clamp applied to its -1e30 start) and
  // this thread's share of the denominator, rows g and g + 8
  float m0r = -1e20f, m1r = -1e20f, l0r = 0.f, l1r = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int slot = kt % kStages;
    if (kt + 1 < n_kt) {  // tile kt + 1 into the slot tile kt - 1 left
      const int nslot = (kt + 1) % kStages;
      load_rows<T, BK, DHP, C::kLdQK>(ks + nslot * BK * C::kLdQK,
                                     kv_row(kb, (kt + 1) * BK), k, Dh, vec);
      load_rows<T, BK, DHP, C::kLdV>(vs + nslot * BK * C::kLdV,
                                    kv_row(vb, (kt + 1) * BK), v, Dh, vec);
    }
    cp_async_commit();  // (an empty group past the last tile)
    cp_async_wait<1>();  // tile kt
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    scores<T, DHP>(s, qf, qw, ks + slot * BK * C::kLdQK, Dh, lane);

    const int k0 = kt * BK;
    float mx0 = kNegInf, mx1 = kNegInf;
    if (k0 + BK <= wlim) {  // uniform: every row of the warp sees the tile
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] *= scale;
          if (e < 2) mx0 = fmaxf(mx0, s[n][e]);
          else mx1 = fmaxf(mx1, s[n][e]);
        }
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          s[n][e] = col < (e < 2 ? lim_a : lim_b) ? s[n][e] * scale : kNegInf;
          if (e < 2) mx0 = fmaxf(mx0, s[n][e]);
          else mx1 = fmaxf(mx1, s[n][e]);
        }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(fmaxf(m0r, mx0), -1e20f);
    const float n1 = fmaxf(fmaxf(m1r, mx1), -1e20f);
    const float a0 = exp2f((m0r - n0) * kLog2e);
    const float a1 = exp2f((m1r - n1) * kLog2e);
    m0r = n0;
    m1r = n1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f((s[n][0] - n0) * kLog2e);
      s[n][1] = exp2f((s[n][1] - n0) * kLog2e);
      s[n][2] = exp2f((s[n][2] - n1) * kLog2e);
      s[n][3] = exp2f((s[n][3] - n1) * kLog2e);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0r = l0r * a0 + ps0;
    l1r = l1r * a1 + ps1;
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }
    accumulate<T, DHP>(o, s, vs + slot * BK * C::kLdV, Dh, lane);
    __syncthreads();  // this slot is refilled by the next step
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = h == 0 ? l0r : l1r;
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_row = fmaxf(l, 1e-30f);
    const int r = warp * 16 + g + 8 * h;
    if (R0 + r >= R1) continue;
    T* orow = out + q_row(r);
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        if (col < Dh) orow[col] = from_f32<T>(o[j][2 * h + e] / l_row);
      }
  }
}

template <typename T, int DHP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pos, const int* counts, void* out, int B, int S,
                   int nh, int nkv, int Dh, int kv_len, long long kv_bs,
                   long long kv_rs, float scale, cudaStream_t stream) {
  constexpr size_t smem = Cfg<T, DHP>::kSmem;
  auto kernel = prefill_attn_kernel<T, DHP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(S) * (nh / nkv);
  const int n_tiles = static_cast<int>((rows + kRows - 1) / kRows);
  const long long n_blocks = static_cast<long long>(n_tiles) * B * nkv;
  if (n_blocks == 0) return cudaSuccess;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const long long strides = (kv_bs | kv_rs) * static_cast<long long>(sizeof(T));
  const bool vec = (Dh * sizeof(T)) % 16 == 0 && addr % 16 == 0 &&
                   strides % 16 == 0;
  kernel<<<static_cast<unsigned>(n_blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, counts, static_cast<T*>(out), B, S, nh,
      nkv, Dh, kv_len, kv_bs, kv_rs, n_tiles, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* pos, const int* counts, void* out, int B,
                     int S, int nh, int nkv, int Dh, int kv_len,
                     long long kv_bs, long long kv_rs, float scale,
                     cudaStream_t stream) {
#define PREFILL_LAUNCH(DHP)                                                \
  return launch<T, DHP>(q, k, v, pos, counts, out, B, S, nh, nkv, Dh,      \
                        kv_len, kv_bs, kv_rs, scale, stream)
  if (Dh < 1 || nkv < 1 || nh % nkv != 0 || kv_len < 0)
    return cudaErrorInvalidValue;
  if (Dh <= 32) PREFILL_LAUNCH(32);
  if (Dh <= 64) PREFILL_LAUNCH(64);
  if (Dh <= 128) PREFILL_LAUNCH(128);
#undef PREFILL_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. 1 <= Dh <= 128, nkv divides nh. counts
// may be null. Returns a cudaError_t.
int flash_prefill(int dtype, const void* q, const void* k, const void* v,
                  const int* pos, const int* counts, void* out, int B, int S,
                  int nh, int nkv, int Dh, int kv_len, long long kv_bs,
                  long long kv_rs, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, pos, counts, out, B, S, nh, nkv, Dh,
                           kv_len, kv_bs, kv_rs, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, pos, counts, out, B, S, nh, nkv,
                                   Dh, kv_len, kv_bs, kv_rs, scale, st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
