// The int8 sweep floor for Hopper (sm_90a): int8 queries against int8 rows,
// reduced per block of rows to the max of its 128-wide strided column groups.
//
// Replaces the two Pallas TPU kernels of
// benchmarks/bench_pallas_int8_matmul.py: kernel_bf16 (K10: both operands
// widened to bf16, the products summed in f32) and kernel_int8 (K11: int8 x
// int8 summed in int32, the max cast to f32).
//
//   out[q, j·128 + c] = max over i < block/128 of
//                       sum_d q[q, d] · e[j·block + i·128 + c, d]
//
// for j < N / block: the grid covers whole blocks only, so rows past the
// last whole block are not read (the TPU kernel's grid is N // BLOCK).
// Every int8 product is exact in bf16 and in int32, and every partial sum
// is an integer below 2^24 while D ≤ 1024 (1024 · 128² = 2^24), so there
// K10's f32 sums are exact in any order and K10 and K11 give the same bits.
//
// Both run on csrc/widen_product.cuh's ring: a producer warp fills `stages`
// slots with TMA boxes of 128 rows × 128 bytes (one layer i of a block:
// rows j·block + i·128 + r, r < 128, strip column r), full and empty
// mbarriers a slot, two consumer warpgroups of 64 rows each; persistent
// blocks, one an SM, the query tiles of a walker neighbours in the grid, so
// that the second reads the rows from L2.
//
// K10 is that file's product, the one K6 runs, with ng 128 and group
// block / 128: each int8 row element widened exactly to bf16 once a block,
// in the registers of the lane that multiplies it; the query tile (16 or 64
// queries) widened once a block into shared memory, resident for the whole
// sweep; bf16 wgmma m64nNQk16 with f32 sums. Its epilogue keeps a running
// max of each (column, query) over the layers in registers and writes the
// strip. K10 never runs s8 products: that is K11's function.
//
// K11 widens nothing: wgmma.mma_async m64nNQk32 s32.s8.s8 with both operands
// K-major in 128-byte-swizzled shared memory, the rows (M, 64 a warpgroup)
// from the ring and the NQ queries (8, 16, 32, 64 or 128; past 128, query
// tiles of 128) from a tile staged once a block and resident when it fits
// beside four stages (D ≤ 1536 at NQ 128, 3072 at 64), else streamed beside
// the rows in each slot as a TMA box of NQ × 128 bytes; any D a multiple of
// 16 (the wrapper pads). A lane keeps its cells' int32 sums of the layer in
// NQ/2 registers and their running max over the layers in NQ/2 more; after
// a block's last layer it casts them to f32 and writes the strip.
//
// Load balance: a walker owns a contiguous range of the nb·(block/128)
// layer tiles, not whole blocks, so every SM gets the same count (±1)
// where 488 blocks over 132 SMs would leave a tail. A block whose layers
// two walkers share is combined in the strip: it is first set to 0xff bytes
// (cudaMemsetAsync, only when such a block exists), and each of the two
// writes its partial maxima with an atomic max in the floats' order
// (atomicMax on the bits of a value ≥ 0, atomicMin on the unsigned bits of
// a negative one; the 0xff pattern loses to both). The cast to f32 is
// monotone, so the max of the casts is the cast of the max: the same bits
// as one walker, in every run. Wholly owned blocks are stored plainly.
//
// What bounds both on an H100: the bytes, N·D int8 read once (1.02 GB at
// the recipe N 1M, D 1024, Q 64: 0.31 ms at 3.35 TB/s), against 2·Q·N·D =
// 1.3e11 operations at Q 64 (0.066 ms at int8's 1,979 TOP/s, 0.13 ms at
// bf16's 989 TFLOP/s) and 5.2e11 at Q 256 (0.26 ms in int8). K11's products
// wait on nothing but their slot; K10 spends ~2 integer operations an
// element of the rows widening them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "widen_product.cuh"

namespace {

constexpr int kLanes = 128;  // the output's column groups, a layer

// ---- K11: s8 wgmma ----

// D += A·Bᵀ for one k32 step: A [64 rows × 32] and B [N × 32] int8, both
// K-major in 128-byte-swizzled shared memory, D [64 × N] s32 in the
// warpgroup's registers (laid out as the f32 accumulator: acc_row,
// acc_query)
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<8> {
  static __device__ __forceinline__ void mma(int (&d)[4], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
        "%0, %1, %2, %3}, "
        "%4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaS8<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaS8<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaS8<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// K11's dynamic shared bytes: the ring (rows, + the streamed query box),
// the resident query tile, the mbarriers; the alignment slack counted
__host__ __device__ constexpr int i8_smem(int nq, int stages, bool resident,
                                          int chunks) {
  return kSmemAlign + stages * (kWRowStage + (resident ? 0 : nq * kWChunk)) +
         (resident ? chunks * nq * kWChunk : 0) + kWBars;
}

inline bool i8_plan_ok(int nq, int stages, bool resident, int chunks) {
  return (nq == 8 || nq == 16 || nq == 32 || nq == 64 || nq == 128) &&
         stages >= 2 && stages <= kWMaxStages &&
         i8_smem(nq, stages, resident, chunks) <= kWMaxSmem;
}

// A walker's tiles t in [lo, hi) of the nb·group layer tiles (tile t: block
// j = t / group, layer a = t % group), a chunk at a time.
struct RangeCursor {
  int t, j, a, c;

  __device__ __forceinline__ void start(const WidenArgs& w, int lo) {
    t = lo;
    j = lo / w.group;
    a = lo - j * w.group;
    c = 0;
  }
  __device__ __forceinline__ void advance(const WidenArgs& w, int,
                                          int chunks) {
    if (++c < chunks) return;
    c = 0;
    ++t;
    if (++a < w.group) return;
    a = 0;
    ++j;
  }
  __device__ __forceinline__ size_t row(const WidenArgs& w, int r) const {
    return static_cast<size_t>(j) * w.block_n +
           static_cast<size_t>(a) * kLanes + r;
  }
};

// the max of *p and v in the floats' order (no NaN, no −0: v is the cast
// of an int32), against a strip set to 0xff bytes first
__device__ __forceinline__ void atomic_max_float(float* p, float v) {
  if (v >= 0.f)
    atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(p), __float_as_uint(v));
}

// K11: walkers × query tiles blocks of kWThreads; w.n_items is the count of
// layer tiles
template <int NQ, bool kResident>
__global__ void __launch_bounds__(kWThreads, 1)
int8_block_max_i8_kernel(const __grid_constant__ CUtensorMap map_e,
                         const __grid_constant__ CUtensorMap map_q,
                         WidenArgs w, float* __restrict__ out, int out_ld) {
  constexpr int kQTile = NQ * kWChunk;  // the query tile's bytes a chunk
  extern __shared__ __align__(16) uint8_t i8_raw[];
  const int chunks = (w.D + kWChunk - 1) / kWChunk;
  const WidenRing ring = widen_ring(i8_raw, w.stages, kResident ? 0 : kQTile,
                                    kResident ? chunks * kQTile : 0);
  const int tid = threadIdx.x;
  const int qtile = blockIdx.x % w.qtiles, walker = blockIdx.x / w.qtiles;
  const int q0 = qtile * NQ;
  const int lo = static_cast<int>(static_cast<long long>(walker) *
                                  w.n_items / w.walkers);
  const int hi = static_cast<int>(static_cast<long long>(walker + 1) *
                                  w.n_items / w.walkers);
  const int n_iter = (hi - lo) * chunks;
  if (n_iter == 0) return;

  widen_ring_init(ring, w.stages);
  // resident queries: the tile's int8 bytes where TMA's 128-byte swizzle
  // would put them (unit p of row r at r·128 + wswz(r, p)), zeros past Q
  // and D, by the consumers once a block
  if (kResident && tid < kWConsumers) {
    const int8_t* q = static_cast<const int8_t*>(w.q);
    for (int v = tid; v < chunks * NQ * 8; v += kWConsumers) {
      const int c = v / (NQ * 8), rem = v - c * NQ * 8;
      const int qr = rem >> 3, p = rem & 7, d = c * kWChunk + 16 * p;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + qr < w.Q && d < w.D)
        x = __ldg(reinterpret_cast<const uint4*>(
            q + static_cast<size_t>(q0 + qr) * w.D + d));
      *reinterpret_cast<uint4*>(ring.resident_q + c * kQTile +
                                qr * kWChunk + wswz(qr, p)) = x;
    }
    fence_proxy_async();
  }
  __syncthreads();

  if (tid >= kWConsumers) {  // the producer warp: lane 0 fills the ring
    if (tid != kWConsumers) return;
    RangeCursor cur;
    cur.start(w, lo);
    widen_produce<kResident ? 0 : 1, kQTile>(ring, w, &map_e, &map_q, cur,
                                             walker, n_iter, chunks, q0);
    return;
  }

  // the consumers: warpgroup wg multiplies tile rows [64·wg, 64·wg + 64)
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int t = lane & 3;
  const int r0 = 64 * wg + 16 * warp + (lane >> 2);  // rows r0, r0 + 8
  int acc[NQ / 2], best[NQ / 2];
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) best[i] = INT32_MIN;  // below every sum
  RangeCursor cur;
  cur.start(w, lo);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % w.stages;
    if (cur.c == 0) {
#pragma unroll
      for (int i = 0; i < NQ / 2; ++i) acc[i] = 0;
    }
    mbar_wait(ring.full + s, (it / w.stages) & 1);
    const uint8_t* rows = ring.slot(s);
    const uint64_t da = sw128_desc(rows + wg * 64 * kWChunk);
    const uint64_t db = sw128_desc(
        kResident ? ring.resident_q + cur.c * kQTile : rows + kWRowStage);
    fence_regs(acc);
    wgmma_fence();
    // all four k steps, past D too (TMA's and the staging's zeros): a
    // step skipped by a branch serializes every wgmma of the loop
#pragma unroll
    for (int k = 0; k < kWChunk / 32; ++k)
      WgmmaS8<NQ>::mma(acc, da + 2 * k, db + 2 * k);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(ring.empty + s);  // the slot's bytes are read
    if (cur.c == chunks - 1) {  // the layer's sums are whole
#pragma unroll
      for (int i = 0; i < NQ / 2; ++i) best[i] = max(best[i], acc[i]);
      if (cur.a == w.group - 1 || cur.t == hi - 1) {  // the run's end
        const bool whole =
            cur.j * w.group >= lo && (cur.j + 1) * w.group <= hi;
#pragma unroll
        for (int i = 0; i < NQ / 2; ++i) {
          const int qr = q0 + acc_query(i, t);
          if (qr < w.Q) {
            float* o = out + static_cast<size_t>(qr) * out_ld +
                       cur.j * kLanes + r0 + acc_row(i);
            const float v = __int2float_rn(best[i]);
            if (whole)
              *o = v;
            else
              atomic_max_float(o, v);
          }
          best[i] = INT32_MIN;
        }
      }
    }
    cur.advance(w, walker, chunks);
  }
}

template <int NQ, bool kResident>
cudaError_t launch_i8(const WidenArgs& w, float* out, int out_ld, bool split,
                      cudaStream_t st) {
  CUtensorMap map_e, map_q;
  cudaError_t err = int8_rows_map(&map_e, w.e, w.N, w.D);
  if (err != cudaSuccess) return err;
  map_q = map_e;
  if (!kResident) {
    err = int8_rows_map(&map_q, w.q, w.Q, w.D, NQ);
    if (err != cudaSuccess) return err;
  }
  static bool sized = false;  // the largest plan's bytes, once a process
  if (!sized) {
    err = cudaFuncSetAttribute(int8_block_max_i8_kernel<NQ, kResident>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWMaxSmem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  if (split) {
    err = cudaMemsetAsync(
        out, 0xff, static_cast<size_t>(w.Q) * out_ld * sizeof(float), st);
    if (err != cudaSuccess) return err;
  }
  const int smem = i8_smem(NQ, w.stages, kResident,
                           (w.D + kWChunk - 1) / kWChunk);
  int8_block_max_i8_kernel<NQ, kResident>
      <<<w.walkers * w.qtiles, kWThreads, smem, st>>>(map_e, map_q, w, out,
                                                      out_ld);
  return cudaGetLastError();
}

template <int NQ>
cudaError_t launch_i8(const WidenArgs& w, bool resident, float* out,
                      int out_ld, bool split, cudaStream_t st) {
  return resident ? launch_i8<NQ, true>(w, out, out_ld, split, st)
                  : launch_i8<NQ, false>(w, out, out_ld, split, st);
}

// ---- K10: the widening product ----

// K10's epilogue of the widening product: the running max of each (column,
// query) over the layers, an integer held exactly in f32; the strip written
// at the item's end
template <int NQ>
struct BlockMaxEpi {
  static constexpr bool kInt8Queries = true;
  float* out;
  int out_ld, lane_t;
  float vmax[NQ / 2];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) vmax[i] = -INFINITY;
  }
  __device__ __forceinline__ void tile_start(const WidenArgs&,
                                             const WidenCursor&, int) {}
  __device__ __forceinline__ void fold(const float (&acc)[NQ / 2], int) {
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) vmax[i] = fmaxf(vmax[i], acc[i]);
  }
  __device__ __forceinline__ void write(const WidenArgs& w,
                                        const WidenCursor& cur, int r0,
                                        int q0) {
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) {
      const int qr = q0 + acc_query(i, lane_t);
      if (qr < w.Q)
        out[static_cast<size_t>(qr) * out_ld + cur.j * kLanes + r0 +
            acc_row(i)] = vmax[i];
    }
  }
};

// K10: NQ queries a block (their tile resident, widened once a block),
// walkers × query tiles blocks; no query map (the int8 queries are widened
// from device memory)
template <int NQ>
__global__ void __launch_bounds__(kWThreads, 1)
int8_block_max_bf16_kernel(const __grid_constant__ CUtensorMap map_e,
                           WidenArgs w, float* __restrict__ out, int out_ld) {
  BlockMaxEpi<NQ> epi;
  epi.out = out;
  epi.out_ld = out_ld;
  epi.lane_t = threadIdx.x & 3;
  widen_sweep<NQ>(w, &map_e, &map_e, epi);
}

template <int NQ>
cudaError_t launch_bf16(const WidenArgs& w, float* out, int out_ld,
                        cudaStream_t st) {
  CUtensorMap map_e;
  cudaError_t err = int8_rows_map(&map_e, w.e, w.N, w.D);
  if (err != cudaSuccess) return err;
  const int smem =
      widen_smem(NQ, w.stages, true, (w.D + kWChunk - 1) / kWChunk);
  err = cudaFuncSetAttribute(int8_block_max_bf16_kernel<NQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  int8_block_max_bf16_kernel<NQ>
      <<<w.walkers * w.qtiles, kWThreads, smem, st>>>(map_e, w, out, out_ld);
  return cudaGetLastError();
}

bool floor_shape_ok(int Q, int N, int D, int block) {
  return Q > 0 && N > 0 && D > 0 && D % 16 == 0 && block >= kLanes &&
         block % kLanes == 0 && N >= block;
}

}  // namespace

extern "C" {

// q [Q, D] int8, e [N, D] int8, both contiguous and 16-byte aligned, D a
// multiple of 16; out [Q, (N / block)·128] f32. Needs block a multiple of
// 128 and N ≥ block. K10 takes the plan of ops/widen_product.py's
// `widen_plan` (nq queries a block, resident; stages). Returns a
// cudaError_t.
int int8_block_max_bf16(const int8_t* q, const int8_t* e, int Q, int N,
                        int D, int block, int nq, int stages, float* out,
                        void* stream) {
  const int chunks = (D + kWChunk - 1) / kWChunk;
  if (!floor_shape_ok(Q, N, D, block) ||
      !widen_plan_ok(nq, stages, true, chunks))
    return cudaErrorInvalidValue;
  WidenArgs w;
  w.q = q;
  w.e = e;
  w.Q = Q;
  w.D = D;
  w.block_n = block;
  w.group = block / kLanes;
  w.ng = kLanes;
  const int nb = N / block;
  w.N = nb * block;  // whole blocks only
  w.n_gchunks = 1;
  w.n_items = nb;
  w.qtiles = (Q + nq - 1) / nq;
  w.walkers = widen_walkers(w.n_items, w.qtiles);
  w.stages = stages;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq == 16) return launch_bf16<16>(w, out, nb * kLanes, st);
  return launch_bf16<64>(w, out, nb * kLanes, st);
}

// K11 takes the plan of ops/int8_matmul.py's `i8_plan`: nq queries a block
// (8, 16, 32, 64 or 128), stages, the query tile resident or streamed.
int int8_block_max_i8(const int8_t* q, const int8_t* e, int Q, int N, int D,
                      int block, int nq, int stages, int resident,
                      float* out, void* stream) {
  const int chunks = (D + kWChunk - 1) / kWChunk;
  if (!floor_shape_ok(Q, N, D, block) ||
      !i8_plan_ok(nq, stages, resident != 0, chunks))
    return cudaErrorInvalidValue;
  WidenArgs w;
  w.q = q;
  w.e = e;
  w.Q = Q;
  w.D = D;
  w.block_n = block;
  w.group = block / kLanes;
  w.ng = kLanes;
  const int nb = N / block;
  w.N = nb * block;  // whole blocks only
  w.n_gchunks = 1;
  w.n_items = nb * w.group;  // layer tiles, cut into contiguous ranges
  w.qtiles = (Q + nq - 1) / nq;
  w.walkers = widen_walkers(w.n_items, w.qtiles);
  w.stages = stages;
  bool split = false;  // a block whose layers two walkers share
  for (int k = 1; k < w.walkers && !split; ++k)
    split = static_cast<long long>(k) * w.n_items / w.walkers % w.group != 0;
  const int ld = nb * kLanes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool res = resident != 0;
  switch (nq) {
    case 8: return launch_i8<8>(w, res, out, ld, split, st);
    case 16: return launch_i8<16>(w, res, out, ld, split, st);
    case 32: return launch_i8<32>(w, res, out, ld, split, st);
    case 64: return launch_i8<64>(w, res, out, ld, split, st);
    default: return launch_i8<128>(w, res, out, ld, split, st);
  }
}

// K11's plan's dynamic shared bytes, as the launch asks for them
int i8_sweep_smem(int nq, int stages, int resident, int chunks) {
  return i8_smem(nq, stages, resident != 0, chunks);
}

// K10's plan's dynamic shared bytes, as the launch asks for them
int widen_sweep_smem(int nq, int stages, int resident, int chunks) {
  return widen_smem(nq, stages, resident != 0, chunks);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
