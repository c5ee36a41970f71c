// The warp-level tensor-core pieces that the flash kernels share
// (flash_fwd.cu: K1; flash_bwd.cu: K8 and K9): TF32 rounding and the
// 3xTF32 split on the ALU, bf16 packing, the mma.sync products (sm_80's
// warp-level tensor-core instructions, which sm_90a keeps), cp.async and a
// tile loader.
//
// 3xTF32: x = big + small with big rounded to TF32 and small = x - big
// exact; an f32 product is big.small' + small.big' + big.big', three
// m16n8k8 TF32 products accumulated in f32. The tensor core reads the top
// 19 bits of small (it ignores the low 13, as CUTLASS's 3xTF32 relies on),
// so a product errs ~2^-21 of its size, the dropped small.small' ~2^-22.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like astype
}

// x rounded to TF32 (10 mantissa bits; the tensor cores ignore the low 13),
// to nearest with ties away from zero, on the ALU: adding half of the last
// kept bit and masking (finite x only), two integer operations in place of
// cvt.rna.tf32.f32.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small: big rounded to TF32, small = x - big exactly (its bits
// the TF32 operand; the tensor core drops the low 13)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// a and b rounded to bf16 (to nearest, ties away), packed: a in the low half
__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  return __byte_perm(__float_as_uint(a) + 0x8000u,
                     __float_as_uint(b) + 0x8000u, 0x7632);
}

// not volatile: the compiler may interleave independent products
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
// one 4-byte word (a zero where !fill)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool fill) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) and columns [col0, col0 + COLS) of one head's
// [S, Dh] matrix into a tile of row stride LD, by a block of THREADS
// threads; zeros past S and Dh. `vec`: Dh is a whole number of 16-byte
// chunks and the matrix 16-byte aligned, so every chunk lies wholly inside
// or outside Dh and goes by cp.async; otherwise element by element
// (synchronously).
template <int THREADS, typename T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int row0, int col0, int S, int Dh,
                                          bool vec) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  if (vec) {
    constexpr int kChunks = COLS / kPer;
    for (int c = threadIdx.x; c < ROWS * kChunks; c += THREADS) {
      const int r = c / kChunks, cc = (c - r * kChunks) * kPer;
      const int row = row0 + r, col = col0 + cc;
      const bool ok = row < S && col < Dh;
      cp_async16(dst + r * LD + cc,
                 ok ? src + static_cast<size_t>(row) * Dh + col : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += THREADS) {
      const int r = e / COLS, cc = e - r * COLS;
      const int row = row0 + r, col = col0 + cc;
      dst[r * LD + cc] = row < S && col < Dh
                             ? src[static_cast<size_t>(row) * Dh + col]
                             : from_f32<T>(0.f);
    }
  }
}

}  // namespace
