// The tensor-core product of the dense selectors csrc/fused_topk.cu (K4)
// and csrc/seg_candidates.cu (K5) for bf16 inputs, on Hopper (sm_90a).
//
// A block of 288 threads: two consumer warpgroups (threads 0-255) and one
// producer warp (256-287). The product of a 128-row tile of e with a query
// tile of NQ queries (NQ = 8 ... 128, a multiple of 8) runs as
// wgmma.mma_async m64nNQk16 with f32 accumulators, the operands swapped for
// small batches: rows of e are the M side (64 a warpgroup), the queries the
// N side, so one query costs an N of 8 and not a 64-row tile. Both operands
// are K-major ([N, D] and [Q, D] row-major as they are) in 128-byte-swizzled
// shared memory.
//
// D goes in 64-wide slices (128 bytes of bf16, one swizzle row) through a
// ring of `stages` slots of (128 rows × 64, NQ queries × 64). Lane 0 of the
// producer warp fills the ring with TMA (cp.async.bulk.tensor.2d from
// host-encoded CUtensorMaps passed __grid_constant__); a full mbarrier per
// slot counts the bytes in, an empty one counts the eight consumer warps
// out. TMA fills the box past D, N and Q with zeros, so a ragged last slice
// needs no code: zero columns add +0 products. The producer walks the same
// tiles as the consumers and runs ahead of them by the depth of the ring,
// so the loads of the next tile overlap a tile's epilogue.
//
// The whole of D stays in one block (no split-K) and each warpgroup adds its
// slices in order, so the sum order is fixed and two runs give the same
// bits; nothing is atomic. bf16 × bf16 products are exact in f32; the tensor
// cores sum them in another order than a SIMT FMA chain (as cuBLAS does).

#pragma once

#include <cuda.h>  // CUtensorMap and the driver's encode signature
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowTile = 128;     // rows of e per tile: 64 per warpgroup
constexpr int kSliceD = 64;       // D per ring slot: 128 bytes of bf16
constexpr int kConsumerThreads = 256;
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kTmaThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kEStageBytes = kRowTile * kSliceD * 2;
constexpr int kSmemAlign = 1024;  // a 128-byte swizzle atom is 8 rows

__host__ __device__ constexpr int q_stage_bytes(int nq) {
  return nq * kSliceD * 2;
}

// bytes of the ring (the slots and their two mbarriers each), before the
// kernel's own shared memory; the alignment slack is counted once
__host__ __device__ constexpr int ring_bytes(int nq, int stages) {
  return kSmemAlign + stages * (kEStageBytes + q_stage_bytes(nq) + 16);
}

// Phase counters, compiled in only with -DTMA_PROBE (the build of
// rag_dpo_tpu_torch/evals/probe_topk.py): lane 0 of each warp adds the
// clock64 cycles it spends in a phase to its block's row of g_probe with
// one fire-and-forget atomic a span (a row a block, so the grid's warps do
// not queue on one address). Without the macro they are no code.
#ifdef TMA_PROBE
enum ProbeSlot {
  kProbeWarp,      // a consumer warp's whole run
  kProbeMain,      // its products (consume_tile), waits for full slots in
  kProbeFull,      // of which waiting for a full slot
  kProbeEpilogue,  // scores to the tile, the two consumer barriers
  kProbeSelect,    // its filter and merge of the tile
  kProbeProducer,  // the producer's whole run
  kProbeEmpty,     // of which waiting for an empty slot
  kProbeSlots
};
constexpr int kProbeRows = 1024;
__device__ unsigned long long g_probe[kProbeRows][kProbeSlots];
#define PROBE_CLOCK(t) const long long t = clock64()
#define PROBE_ADD(slot, t)                                                \
  do {                                                                    \
    if ((threadIdx.x & 31) == 0)                                          \
      atomicAdd(&g_probe[(blockIdx.y * gridDim.x + blockIdx.x) %          \
                         kProbeRows][slot],                               \
                static_cast<unsigned long long>(clock64() - (t)));        \
  } while (0)
#else
#define PROBE_CLOCK(t)
#define PROBE_ADD(slot, t)
#endif

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
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

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major tile in 128-byte-swizzled shared memory:
// 8-row groups 1024 bytes apart (SBO), the leading offset unused under the
// swizzle; a k16 step inside the 64-wide slice adds 32 bytes (2 units)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads across the async ops
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the consumer warpgroups' barrier (named barrier 1; the producer warp is
// not in it)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// D += A·Bᵀ for one k16 step: A [64 rows × 16] and B [N × 16], both K-major
// bf16, D [64 × N] f32 in the warpgroup's registers
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// The tile of accumulator i of consumer thread ct (0-255): its row in the
// 128-row tile (warpgroup ct/128 holds rows 64·(ct/128) ...; warp w of it
// rows 16w ... 16w + 15) and its query column (pairs of columns per
// 8-wide block, as the wgmma f32 fragment lays them out).
__device__ __forceinline__ int frag_row(int ct, int i) {
  return (ct >> 7) * 64 + ((ct >> 5) & 3) * 16 + ((ct & 31) >> 2) +
         ((i >> 1) & 1) * 8;
}
__device__ __forceinline__ int frag_col(int ct, int i) {
  return (i >> 2) * 8 + (ct & 3) * 2 + (i & 1);
}

struct Ring {
  uint8_t* e;      // [stages][128 rows × 64] swizzled bf16
  uint8_t* q;      // [stages][NQ × 64]
  uint64_t* full;  // [stages]: the slot's bytes are in
  uint64_t* empty; // [stages]: the eight consumer warps are done with it
  int stages;
};

// The ring at the 1024-aligned start of dynamic shared memory; returns the
// first byte after it. Thread 0 initialises the barriers; the caller syncs
// the block before any role starts.
__device__ __forceinline__ uint8_t* ring_setup(uint8_t* raw, int nq,
                                               int stages, Ring& ring) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(raw);
  uint8_t* base = raw + ((kSmemAlign - (a & (kSmemAlign - 1))) &
                         (kSmemAlign - 1));
  ring.e = base;
  ring.q = ring.e + stages * kEStageBytes;
  ring.full = reinterpret_cast<uint64_t*>(ring.q + stages * q_stage_bytes(nq));
  ring.empty = ring.full + stages;
  ring.stages = stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(ring.full + s, 1);
      mbar_init(ring.empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return reinterpret_cast<uint8_t*>(ring.empty + stages);
}

// Producer (one thread): the D slices of rows [base, base + 128) and of the
// query tile at q0 into the ring. `it` counts the slots filled so far.
template <int NQ>
__device__ __forceinline__ void produce_tile(const CUtensorMap* map_e,
                                             const CUtensorMap* map_q,
                                             const Ring& ring, int n_slices,
                                             uint32_t& it, int base, int q0) {
  for (int c = 0; c < n_slices; ++c, ++it) {
    const int s = it % ring.stages;
    PROBE_CLOCK(t_wait);
    mbar_wait(ring.empty + s, ((it / ring.stages) & 1) ^ 1);
    PROBE_ADD(kProbeEmpty, t_wait);
    mbar_expect_tx(ring.full + s, kEStageBytes + q_stage_bytes(NQ));
    tma_load_2d(ring.e + s * kEStageBytes, map_e, ring.full + s,
                c * kSliceD, base);
    tma_load_2d(ring.q + s * q_stage_bytes(NQ), map_q, ring.full + s,
                c * kSliceD, q0);
  }
}

// Consumers (both warpgroups): acc = this warpgroup's 64 rows of the tile
// times the query tile, over all of D, slices in order. `it` counts the
// slots consumed so far; a slot goes back to the producer as soon as the
// products that read it are done.
template <int NQ>
__device__ __forceinline__ void consume_tile(const Ring& ring, int n_slices,
                                             uint32_t& it, int ct,
                                             float (&acc)[NQ / 2]) {
  const int wg = ct >> 7;
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);
  for (int c = 0; c < n_slices; ++c, ++it) {
    const int s = it % ring.stages;
    PROBE_CLOCK(t_wait);
    mbar_wait(ring.full + s, (it / ring.stages) & 1);
    PROBE_ADD(kProbeFull, t_wait);
    const uint64_t da =
        sw128_desc(ring.e + s * kEStageBytes + wg * (kEStageBytes / 2));
    const uint64_t db = sw128_desc(ring.q + s * q_stage_bytes(NQ));
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSliceD / 16; ++j)
      Wgmma<NQ>::mma(acc, da + 2 * j, db + 2 * j);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    if ((ct & 31) == 0) mbar_arrive(ring.empty + s);  // one arrival a warp
  }
}

// ---- host side: the tensor maps ----

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

// The map of a [rows, D] row-major bf16 matrix read in boxes of
// box_rows × 64, 128-byte swizzled, zeros outside. D % 8 == 0 (TMA takes
// row strides in multiples of 16 bytes) and a 16-byte-aligned pointer.
cudaError_t bf16_map(CUtensorMap* map, const void* ptr, int rows, int D,
                     int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {kSliceD, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the wgmma widths the selectors are built for
constexpr bool tc_tile_ok(int nq) {
  return nq == 8 || nq == 16 || nq == 32 || nq == 64 || nq == 128;
}

}  // namespace
