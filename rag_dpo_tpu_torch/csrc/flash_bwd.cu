// Flash-attention backward for Hopper (sm_90a): dq, and dk with dv, of the
// length-masked non-causal attention that flash_fwd.cu computes, every
// product on the tensor cores.
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
// Layout: q, k, v, dout and the gradients are [B, H, S, DH] contiguous;
// lengths [B] int32; lse and D [B, H, S] f32. DH is one of 16, 32, 64, 128,
// 256 and 512: the wrapper pads other widths with zero columns, which add
// exact zeros to every sum. Two kernels, no atomics, the same bits run to
// run. A block of 4 warps (2 for f32 at DH 512) owns 16 rows a warp of its
// own side, a query tile for dq and a key tile for dk/dv, and walks the
// other side's tiles below min(lengths[b], S) in a two-stage ring of
// 16-byte cp.async loads (zeros past S), so tile t+1 loads while tile t is
// multiplied; tiles at or past the length, and whole blocks there, do no
// work (their P is 0). A grid row y takes output columns [128 y, 128 y +
// 128) past DH 128, recomputing the scores for its columns, so the
// accumulators stay in registers at any width.
//
// The products run on mma.sync, as in flash_fwd.cu (mma_sync.cuh): f32 as
// 3xTF32 (~2^-21 a product), bf16 scores on m16n8k16 (exact in f32) and the
// products with an f32 left operand (P or dS) as one m16n8k16 of its hi +
// lo bf16 halves against the right operand twice. Nothing goes through
// shared memory between products: the accumulator fragment of a score tile
// (keys 2t, 2t+1 of rows g, g+8) is the A fragment of the next product,
// its k order taken as (2t, 2t+1) and the B rows read in that order.
//   dq:    S = Q.K^T and dP = dO.V^T, dS in place, dQ += dS.K
//   dk/dv: S^T = K.Q^T and dP^T = V.dO^T with the block's keys as rows, so
//          P^T and dS^T are A fragments of dV += P^T.dO and dK += dS^T.Q;
//          lse and D come per column from the ring.
// Rows in shared memory are padded by 16 bytes: a warp's fragment loads,
// by row (row g, column t) and by column (row 2t, column g), fall in
// distinct banks.
//
// What bounds it on an H100: at the training shape the bytes (~0.011 and
// ~0.014 ms); the kernels take about 5 times that (PERF.md). Each warp
// splits (round, subtract) every f32 fragment it reads from shared
// memory, three ALU operations an element, ~1/5 of the time at DH 64:
// splitting a walked tile once a block into big and small planes would
// need twice the shared memory, one block an SM in place of two, which
// costs more than the split (evals/probe_flash_bwd.py).

#include <math.h>

#include "mma_sync.cuh"

namespace {

constexpr int kStages = 2;  // the walked tiles' ring
constexpr float kLog2e = 1.4426950408889634f;
// a block's shared bytes: at most the 227 KB a block can take; where they
// allow, little enough for two blocks an SM
constexpr size_t kMaxSmem = 232448, kTwoBlocks = 113 * 1024;

template <typename T, int DH>
constexpr int warps() {
  return sizeof(T) == 4 && DH == 512 ? 2 : 4;
}
// a block's shared bytes with walked tiles of w rows: its own rows of two
// inputs and the ring of the walked side's two (dk/dv: with their lse and D)
template <typename T, int DH, bool DKV>
constexpr size_t smem_bytes(int w) {
  return sizeof(T) * (DH + 16 / sizeof(T)) *
             (2 * 16 * static_cast<size_t>(warps<T, DH>()) +
              kStages * 2 * static_cast<size_t>(w)) +
         (DKV ? sizeof(float) * kStages * 2 * w : 0);
}
// walked rows a tile: as many as the registers allow (dk/dv keeps two
// accumulators), halved until the block's bytes fit `limit`
template <typename T, int DH, bool DKV>
constexpr int fit_rows(size_t limit) {
  int w = !DKV || DH <= 64 ? 64 : 32;
  while (w > 8 && smem_bytes<T, DH, DKV>(w) > limit) w /= 2;
  return w;
}

template <typename T, int DH, bool DKV>
struct Cfg {
  static constexpr int kWarps = warps<T, DH>();
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;  // the block's own rows
  static constexpr int kDV = DH <= 128 ? DH : 128;  // output columns a block
  static constexpr int kPasses = DH / kDV;
  static constexpr int kLd = DH + 16 / static_cast<int>(sizeof(T));
  // two blocks an SM where the bytes allow, else one
  static constexpr int kW =
      smem_bytes<T, DH, DKV>(fit_rows<T, DH, DKV>(kTwoBlocks)) <= kTwoBlocks
          ? fit_rows<T, DH, DKV>(kTwoBlocks)
          : fit_rows<T, DH, DKV>(kMaxSmem);
  static constexpr size_t kSmem = smem_bytes<T, DH, DKV>(kW);
  static_assert(kSmem <= kMaxSmem, "a block's tiles do not fit");
};

// acc[n] += A[16 rows] . B[rows 8n .. 8n + 7]^T over the DH columns of two
// tiles of row stride LD: the scores of a warp's 16 own rows (A) against a
// walked tile (B). f32: 3xTF32 per 8 columns, fragments in the standard k
// order (columns t, t + 4). bf16: one m16n8k16 per 16 columns.
template <typename T, int DH, int NT, int LD>
__device__ __forceinline__ void product_rows(float (&acc)[NT][4], const T* a,
                                             const T* b, int g, int t) {
  if constexpr (sizeof(T) == 4) {
    const float* af = reinterpret_cast<const float*>(a);
    const float* bf = reinterpret_cast<const float*>(b);
#pragma unroll
    for (int c0 = 0; c0 < DH; c0 += 8) {
      uint32_t ab[4], ax[4];
      split(af[g * LD + c0 + t], ab[0], ax[0]);
      split(af[(g + 8) * LD + c0 + t], ab[1], ax[1]);
      split(af[g * LD + c0 + t + 4], ab[2], ax[2]);
      split(af[(g + 8) * LD + c0 + t + 4], ab[3], ax[3]);
      // the B fragments of every slice, then each kind of product over all
      // slices, so no product waits on the one before it
      uint32_t b0[NT], b1[NT], x0[NT], x1[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* row = bf + (n * 8 + g) * LD + c0 + t;
        split(row[0], b0[n], x0[n]);
        split(row[4], b1[n], x1[n]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_tf32(acc[n], ab, x0[n], x1[n]);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_tf32(acc[n], ax, b0[n], b1[n]);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_tf32(acc[n], ab, b0[n], b1[n]);
    }
  } else {
#pragma unroll
    for (int c0 = 0; c0 < DH; c0 += 16) {
      uint32_t af[4];
      const T* ar = a + c0 + 2 * t;
      af[0] = *reinterpret_cast<const uint32_t*>(ar + g * LD);
      af[1] = *reinterpret_cast<const uint32_t*>(ar + (g + 8) * LD);
      af[2] = *reinterpret_cast<const uint32_t*>(ar + g * LD + 8);
      af[3] = *reinterpret_cast<const uint32_t*>(ar + (g + 8) * LD + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const T* br = b + (n * 8 + g) * LD + c0 + 2 * t;
        mma_bf16(acc[n], af, *reinterpret_cast<const uint32_t*>(br),
                 *reinterpret_cast<const uint32_t*>(br + 8));
      }
    }
  }
}

// acc[j] += P[16 rows, the walked tile's 8·NT rows] . B[those rows, columns
// col0 + 8j .. col0 + 8j + 7], P given as score fragments p[n] (rows g and
// g + 8, walked rows 8n + 2t and 8n + 2t + 1). f32: P's split parts are A
// fragments of m16n8k8 read as k = (2t, 2t+1), so B's rows go in that
// order; 3xTF32. bf16: P = hi + lo in bf16 against B twice, one m16n8k16.
template <typename T, int NT, int NV, int LD>
__device__ __forceinline__ void product_cols(float (&acc)[NV][4],
                                             const float (&p)[NT][4],
                                             const T* b, int col0, int g,
                                             int t) {
  constexpr int G = NV < 8 ? NV : 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t ab[4], ax[4];
    if constexpr (sizeof(T) == 4) {
      // the TF32 fragment wants (g: 2t, g+8: 2t, g: 2t+1, g+8: 2t+1)
      split(p[n][0], ab[0], ax[0]);
      split(p[n][2], ab[1], ax[1]);
      split(p[n][1], ab[2], ax[2]);
      split(p[n][3], ab[3], ax[3]);
    } else {
      float hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = __uint_as_float((__float_as_uint(p[n][e]) + 0x8000u) &
                                0xffff0000u);
        lo[e] = p[n][e] - hi[e];
      }
      ax[0] = bf16x2(hi[0], hi[1]);
      ax[1] = bf16x2(hi[2], hi[3]);
      ax[2] = bf16x2(lo[0], lo[1]);
      ax[3] = bf16x2(lo[2], lo[3]);
    }
    const T* b0r = b + (n * 8 + 2 * t) * LD + col0 + g;
    // the output slices in groups of 8: each group's B fragments, then each
    // kind of product over the group
#pragma unroll
    for (int j0 = 0; j0 < NV; j0 += G) {
      uint32_t b0[G], b1[G], x0[G], x1[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if constexpr (sizeof(T) == 4) {
          split(b0r[(j0 + j) * 8], b0[j], x0[j]);
          split(b0r[LD + (j0 + j) * 8], b1[j], x1[j]);
        } else {  // rows 2t, 2t + 1, for P's hi and lo halves
          const uint16_t* r16 = reinterpret_cast<const uint16_t*>(b0r);
          x0[j] = x1[j] = static_cast<uint32_t>(r16[(j0 + j) * 8]) |
                          static_cast<uint32_t>(r16[LD + (j0 + j) * 8]) << 16;
        }
      }
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int j = 0; j < G; ++j) mma_tf32(acc[j0 + j], ab, x0[j], x1[j]);
#pragma unroll
        for (int j = 0; j < G; ++j) mma_tf32(acc[j0 + j], ax, b0[j], b1[j]);
#pragma unroll
        for (int j = 0; j < G; ++j) mma_tf32(acc[j0 + j], ab, b0[j], b1[j]);
      } else {
#pragma unroll
        for (int j = 0; j < G; ++j) mma_bf16(acc[j0 + j], ax, x0[j], x1[j]);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&x)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
}

// a warp's 16 rows of one output (rows g and g + 8, columns col0 + 8j + 2t
// and + 1), times `mul`, on the rows below S; 0 on rows at or past `len`
template <typename T, int NV>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[NV][4],
                                           int r0, int col0, int S, int DH,
                                           int len, float mul, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= S) continue;
    const bool live = row < len;
    T* orow = out + static_cast<size_t>(row) * DH + col0 + 2 * t;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      orow[j * 8] = from_f32<T>(live ? acc[j][2 * h] * mul : 0.f);
      orow[j * 8 + 1] = from_f32<T>(live ? acc[j][2 * h + 1] * mul : 0.f);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(Cfg<T, DH, false>::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const int* __restrict__ lengths,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, T* __restrict__ dq, int H,
                    int S, int n_qtiles, float scale, bool vec) {
  using C = Cfg<T, DH, false>;
  constexpr int R = C::kRows, W = C::kW, NT = W / 8, NV = C::kDV / 8;
  constexpr int LD = C::kLd, TH = C::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [R][LD]
  T* dos = qs + R * LD;                     // [R][LD]
  T* ks = dos + R * LD;                     // [kStages][W][LD]
  T* vs = ks + kStages * W * LD;            // [kStages][W][LD]

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * R;
  const int col0 = blockIdx.y * C::kDV;
  const int b = bh / H;
  const size_t base = static_cast<size_t>(bh) * S * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int len = max(0, min(lengths[b], S));
  const int r0 = q0 + warp * 16;  // the warp's first query row
  const bool live = r0 < len;     // warp-uniform
  // dq is 0 on rows at or past the length, so such a block walks nothing
  const int n_ktiles = q0 < len ? (len + W - 1) / W : 0;

  float acc[NV][4];
  zero(acc);
  // rows g and g + 8: lse and D in the log2 domain of exp2f
  float lse2[2], rdd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    const size_t i = static_cast<size_t>(bh) * S + min(row, S - 1);
    lse2[h] = row < len ? lse[i] * kLog2e : 0.f;
    rdd[h] = row < len ? dd[i] : 0.f;
  }
  const float scale2 = scale * kLog2e;

  if (n_ktiles > 0) {
    load_tile<TH, T, R, DH, LD>(qs, q + base, q0, 0, S, DH, vec);
    load_tile<TH, T, R, DH, LD>(dos, dout + base, q0, 0, S, DH, vec);
    load_tile<TH, T, W, DH, LD>(ks, k + base, 0, 0, S, DH, vec);
    load_tile<TH, T, W, DH, LD>(vs, v + base, 0, 0, S, DH, vec);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int slot = kt % kStages;
    const int ahead = kt + kStages - 1;  // into the slot tile kt - 1 left
    if (ahead < n_ktiles) {
      const int ns = ahead % kStages;
      load_tile<TH, T, W, DH, LD>(ks + ns * W * LD, k + base, ahead * W, 0,
                                  S, DH, vec);
      load_tile<TH, T, W, DH, LD>(vs + ns * W * LD, v + base, ahead * W, 0,
                                  S, DH, vec);
    }
    cp_async_commit();  // (an empty group past the last tile)
    cp_async_wait<kStages - 1>();
    __syncthreads();

    if (live) {
      const T* kt_s = ks + slot * W * LD;
      float s[NT][4], dp[NT][4];
      zero(s);
      zero(dp);
      product_rows<T, DH, NT, LD>(s, qs + warp * 16 * LD, kt_s, g, t);
      product_rows<T, DH, NT, LD>(dp, dos + warp * 16 * LD,
                                  vs + slot * W * LD, g, t);
      const int k0 = kt * W;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const int h = e >> 1;
          const float p = key < len
                              ? exp2f(fmaf(s[n][e], scale2, -lse2[h]))
                              : 0.f;
          s[n][e] = p * (dp[n][e] - rdd[h]);  // dS, in place
        }
      product_cols<T, NT, NV, LD>(acc, s, kt_s, col0, g, t);
    }
    __syncthreads();  // this slot is refilled by the next step
  }
  cp_async_wait<0>();
  store_rows<T, NV>(dq + base, acc, r0, col0, S, DH, len, scale, g, t);
}

template <typename T, int DH>
__global__ void __launch_bounds__(Cfg<T, DH, true>::kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const int* __restrict__ lengths,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int S, int n_ktiles,
                     float scale, bool vec) {
  using C = Cfg<T, DH, true>;
  constexpr int R = C::kRows, W = C::kW, NT = W / 8, NV = C::kDV / 8;
  constexpr int LD = C::kLd, TH = C::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [R][LD]
  T* vs = ks + R * LD;                      // [R][LD]
  T* qs = vs + R * LD;                      // [kStages][W][LD]
  T* dos = qs + kStages * W * LD;           // [kStages][W][LD]
  // lse and D of the walked query rows: [kStages][W] each
  float* lses = reinterpret_cast<float*>(dos + kStages * W * LD);
  float* dds = lses + kStages * W;

  const int bh = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x % n_ktiles) * R;
  const int col0 = blockIdx.y * C::kDV;
  const int b = bh / H;
  const size_t base = static_cast<size_t>(bh) * S * DH;
  const size_t row_base = static_cast<size_t>(bh) * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int len = max(0, min(lengths[b], S));
  const int r0 = k0 + warp * 16;  // the warp's first key
  const bool live = r0 < len;
  // keys at or past the length get P = 0 from every query: dk = dv = 0
  const int n_qtiles = k0 < len ? (len + W - 1) / W : 0;
  const float scale2 = scale * kLog2e;

  // lse and D of query rows [row0, row0 + W) into ring slot `ns`
  auto load_stats = [&](int ns, int row0) {
    for (int i = threadIdx.x; i < 2 * W; i += TH) {
      const int r = i < W ? i : i - W, row = row0 + r;
      const float* src = i < W ? lse : dd;
      float* dst = (i < W ? lses : dds) + ns * W + r;
      cp_async4(dst, src + row_base + min(row, S - 1), row < S);
    }
  };

  float acc_k[NV][4], acc_v[NV][4];
  zero(acc_k);
  zero(acc_v);
  if (n_qtiles > 0) {
    load_tile<TH, T, R, DH, LD>(ks, k + base, k0, 0, S, DH, vec);
    load_tile<TH, T, R, DH, LD>(vs, v + base, k0, 0, S, DH, vec);
    load_tile<TH, T, W, DH, LD>(qs, q + base, 0, 0, S, DH, vec);
    load_tile<TH, T, W, DH, LD>(dos, dout + base, 0, 0, S, DH, vec);
    load_stats(0, 0);
    cp_async_commit();
  }
  for (int it = 0; it < n_qtiles; ++it) {
    const int slot = it % kStages;
    const int ahead = it + kStages - 1;
    if (ahead < n_qtiles) {
      const int ns = ahead % kStages;
      load_tile<TH, T, W, DH, LD>(qs + ns * W * LD, q + base, ahead * W, 0,
                                  S, DH, vec);
      load_tile<TH, T, W, DH, LD>(dos + ns * W * LD, dout + base, ahead * W,
                                  0, S, DH, vec);
      load_stats(ns, ahead * W);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();

    if (live) {
      const T* qt_s = qs + slot * W * LD;
      const T* dot_s = dos + slot * W * LD;
      const float* ls = lses + slot * W;
      const float* ds = dds + slot * W;
      float s[NT][4], dp[NT][4];  // S^T, dP^T: the block's keys as rows
      zero(s);
      zero(dp);
      product_rows<T, DH, NT, LD>(s, ks + warp * 16 * LD, qt_s, g, t);
      product_rows<T, DH, NT, LD>(dp, vs + warp * 16 * LD, dot_s, g, t);
      const int q0 = it * W;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = n * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
        const float2 d2 = *reinterpret_cast<const float2*>(ds + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = r0 + g + 8 * (e >> 1);
          const bool odd = e & 1;
          const bool ok = key < len && q0 + c + odd < len;
          const float p =
              ok ? exp2f(fmaf(s[n][e], scale2, -(odd ? l2.y : l2.x) * kLog2e))
                 : 0.f;
          s[n][e] = p;                                   // P^T
          dp[n][e] = p * (dp[n][e] - (odd ? d2.y : d2.x));  // dS^T
        }
      }
      product_cols<T, NT, NV, LD>(acc_v, s, dot_s, col0, g, t);
      product_cols<T, NT, NV, LD>(acc_k, dp, qt_s, col0, g, t);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  // keys at or past the length: P was 0, so these are exact zeros anyway
  store_rows<T, NV>(dk + base, acc_k, r0, col0, S, DH, S, scale, g, t);
  store_rows<T, NV>(dv + base, acc_v, r0, col0, S, DH, S, 1.f, g, t);
}

bool aligned16(const void* a, const void* b, const void* c, const void* d) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
          reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) %
             16 ==
         0;
}

template <typename T, int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const int* lengths, const float* lse,
                      const float* dd, void* dq, int B, int H, int S,
                      float scale, cudaStream_t stream) {
  using C = Cfg<T, DH, false>;
  auto kernel = flash_bwd_dq_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const int n_qtiles = (S + C::kRows - 1) / C::kRows;
  const long long n_blocks = static_cast<long long>(n_qtiles) * B * H;
  if (n_blocks == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>(n_blocks), C::kPasses);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lengths, lse, dd,
      static_cast<T*>(dq), H, S, n_qtiles, scale, aligned16(q, k, v, dout));
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const int* lengths, const float* lse,
                       const float* dd, void* dk, void* dv, int B, int H,
                       int S, float scale, cudaStream_t stream) {
  using C = Cfg<T, DH, true>;
  auto kernel = flash_bwd_dkv_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const int n_ktiles = (S + C::kRows - 1) / C::kRows;
  const long long n_blocks = static_cast<long long>(n_ktiles) * B * H;
  if (n_blocks == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>(n_blocks), C::kPasses);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lengths, lse, dd,
      static_cast<T*>(dk), static_cast<T*>(dv), H, S, n_ktiles, scale,
      aligned16(q, k, v, dout));
  return cudaGetLastError();
}

#define K89_WIDTHS(X) X(16) X(32) X(64) X(128) X(256) X(512)

template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v,
                        const void* dout, const int* lengths,
                        const float* lse, const float* dd, void* dq, int B,
                        int H, int S, int Dh, float scale,
                        cudaStream_t st) {
#define K8_CASE(DH)                                                       \
  case DH:                                                                \
    return launch_dq<T, DH>(q, k, v, dout, lengths, lse, dd, dq, B, H, S, \
                            scale, st);
  switch (Dh) {
    K89_WIDTHS(K8_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef K8_CASE
}

template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const int* lengths,
                         const float* lse, const float* dd, void* dk,
                         void* dv, int B, int H, int S, int Dh, float scale,
                         cudaStream_t st) {
#define K9_CASE(DH)                                                          \
  case DH:                                                                   \
    return launch_dkv<T, DH>(q, k, v, dout, lengths, lse, dd, dk, dv, B, H, \
                             S, scale, st);
  switch (Dh) {
    K89_WIDTHS(K9_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef K9_CASE
}

template <typename T>
long long smem_of(int dkv, int Dh) {
#define K89_SMEM(DH)                                                    \
  case DH:                                                              \
    return static_cast<long long>(dkv ? Cfg<T, DH, true>::kSmem         \
                                      : Cfg<T, DH, false>::kSmem);
  switch (Dh) {
    K89_WIDTHS(K89_SMEM)
    default: return -1;
  }
#undef K89_SMEM
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

// Shared bytes a block of dq (dkv = 0) or dk/dv (dkv = 1) takes at a kernel
// width Dh (16 … 512; -1 for another); the smoke's record reads it.
long long flash_bwd_smem(int dkv, int dtype, int Dh) {
  return dtype == 0 ? smem_of<float>(dkv, Dh)
                    : smem_of<__nv_bfloat16>(dkv, Dh);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
