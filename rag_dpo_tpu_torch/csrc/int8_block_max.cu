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
// K10 is csrc/widen_product.cuh's product, the one K6 runs, with ng 128
// and group block / 128: each int8 row element widened exactly to bf16 once
// a block, in the registers of the lane that multiplies it; the query tile
// (16 or 64 queries) widened once a block into shared memory, resident for
// the whole sweep; bf16 wgmma m64nNQk16 with f32 sums. Its epilogue keeps
// a running max of each (column, query) over the layers in registers and
// writes the strip. K10 never runs s8 products: that is K11's function.
//
// K11: a block of 4 warps owns one row block j and a tile of 16 (Q ≤ 16)
// or 64 queries. It walks the block's 128-row slices i, each slice over D
// in 128-byte chunks (a whole L2 line of each row a stage: 64-byte pieces
// of 1024-byte rows read at 1.8 TB/s on an H100), the chunk of the slice's
// rows and of the query tile arriving through a four-stage cp.async ring,
// its 16-byte pieces XOR-swizzled in shared memory so that the fragment
// loads of rows g and g + 1 fall in different banks; warp w owns slice rows
// [32w, 32w + 32) against the whole query tile. The products run on the
// tensor cores as mma.sync m16n8k32 s8 x s8 -> s32. After a slice's last
// chunk each warp folds its accumulators into a running max in registers:
// row r of block j lands in column r mod 128, as the TPU kernel's unrolled
// strided max has it. No [Q, N] product reaches memory, and no atomics are
// used: every output element is written once by the one lane that owns it.
//
// A sum over d may take the d in any order, as long as both operands take
// the same one: lane (g, t) of a warp reads pieces t and t + 4 (bytes
// [16t, 16t + 16) of each half) of each row it needs from a chunk, one
// 16-byte shared load a row and half, and the mma k slots of its fragments
// are filled from those bytes (see `compute`).
//
// What bounds both on an H100: the bytes, N·D int8 read once (1.02 GB at
// the recipe N 1M, D 1024, Q 64: 0.31 ms at 3.35 TB/s), against 2·Q·N·D =
// 1.3e11 operations (0.066 ms at int8's 1,979 TOP/s, 0.13 ms at bf16's 989
// TFLOP/s). K11 reads the queries again from L2 for each slice (half the
// rows' bytes at Q 64), which the ring hides; K10 spends ~2 integer
// operations an element of the rows widening them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"
#include "widen_product.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 128;        // the output's column groups, a slice
constexpr int kChunk = 128;        // D bytes a stage
constexpr int kPieces = kChunk / 16;
constexpr int kStages = 4;

// dynamic shared bytes: the ring's row and query chunks
template <int MQ>
constexpr int smem_bytes() {
  return kStages * (kLanes + 16 * MQ) * kChunk;
}

// where 16-byte piece p of a chunk row r sits: rows of odd r hold their two
// halves swapped, so the 8 lanes of a 16-byte load phase (rows g = 2i and
// 2i + 1, pieces t or t + 4) cover all 32 banks
__device__ __forceinline__ int swizzle(int r, int p) {
  return p ^ ((r & 1) << 2);
}

// the 32-bit word i of a 16-byte fragment piece
__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage: the chunk [d0, d0 + 128) of the slice's 128 rows (from row0)
// and of the query tile's TQ rows (from q0); zeros past D and Q.
template <int TQ>
__device__ __forceinline__ void load_stage(int8_t* es, int8_t* qs,
                                           const int8_t* __restrict__ e,
                                           const int8_t* __restrict__ q,
                                           size_t row0, int q0, int Q, int D,
                                           int d0) {
  for (int p = threadIdx.x; p < kLanes * kPieces; p += kThreads) {
    const int r = p / kPieces, piece = p % kPieces, d = d0 + piece * 16;
    const bool ok = d < D;
    cp_async16(es + r * kChunk + 16 * swizzle(r, piece),
               ok ? e + (row0 + r) * D + d : e, ok);
  }
  for (int p = threadIdx.x; p < TQ * kPieces; p += kThreads) {
    const int r = p / kPieces, piece = p % kPieces, d = d0 + piece * 16;
    const bool ok = q0 + r < Q && d < D;
    cp_async16(qs + r * kChunk + 16 * swizzle(r, piece),
               ok ? q + static_cast<size_t>(q0 + r) * D + d : q, ok);
  }
}

// The products of one 16-byte piece of each row (see `compute`):
// m16n8k32, a0/a2 (row g) hold k 4t..4t+3 / 4t+16..4t+19, a1/a3 the same
// of row g + 8, b0/b1 those k of column g; step s takes words 2s and 2s + 1
template <int MQ>
__device__ __forceinline__ void compute_piece(const uint4 (&a)[MQ][2],
                                              const uint4 (&b)[4],
                                              int (&acc)[MQ][4][4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int mt = 0; mt < MQ; ++mt) {
      const uint32_t af[4] = {word(a[mt][0], 2 * s), word(a[mt][1], 2 * s),
                              word(a[mt][0], 2 * s + 1),
                              word(a[mt][1], 2 * s + 1)};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_s8(acc[mt][nt], af, word(b[nt], 2 * s), word(b[nt], 2 * s + 1));
    }
}

// The products of one stage into acc[mt][nt]: query tile rows 16mt + (g,
// g + 8) against slice rows 32w + 8nt + g. In each half of the chunk, lane
// (g, t) holds piece t + 4·half of each of its rows (all of them of g's
// parity, so one swizzle); for a product step s the k slots of its A and B
// fragments take words of those 16 bytes, the same words for A and B, so
// each step sums a distinct part of the chunk and the steps of both halves
// together sum all 128 bytes.
template <int MQ>
__device__ __forceinline__ void compute(const int8_t* es, const int8_t* qs,
                                        int warp, int g, int t,
                                        int (&acc)[MQ][4][4]) {
#pragma unroll
  for (int half = 0; half < kChunk / 64; ++half) {
    const int at = 16 * swizzle(g, t + 4 * half);
    uint4 a[MQ][2], b[4];
#pragma unroll
    for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[mt][h] = *reinterpret_cast<const uint4*>(
            qs + (16 * mt + g + 8 * h) * kChunk + at);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      b[nt] = *reinterpret_cast<const uint4*>(
          es + (32 * warp + 8 * nt + g) * kChunk + at);
    compute_piece<MQ>(a, b, acc);
  }
}

// K11
template <int MQ>
__global__ void __launch_bounds__(kThreads, 2)
int8_block_max_kernel(const int8_t* __restrict__ q,
                      const int8_t* __restrict__ e, int Q, int D, int block,
                      float* __restrict__ out, int out_ld) {
  constexpr int TQ = 16 * MQ;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* const es = smem;                               // [kStages] rows
  int8_t* const qs = smem + kStages * kLanes * kChunk;   // [kStages] queries

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j = blockIdx.x, q0 = blockIdx.y * TQ;
  const int n_chunks = (D + kChunk - 1) / kChunk;
  const int n_iter = (block / kLanes) * n_chunks;
  const size_t base = static_cast<size_t>(j) * block;

  int acc[MQ][4][4], best[MQ][4][4];
#pragma unroll
  for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[mt][nt][r] = 0;
        best[mt][nt][r] = INT32_MIN;  // below every sum
      }

  // iteration it loads slice it / n_chunks, chunk it % n_chunks
  auto load = [&](int it) {
    const int slice = it / n_chunks, c = it - slice * n_chunks;
    load_stage<TQ>(es + (it % kStages) * kLanes * kChunk,
                   qs + (it % kStages) * TQ * kChunk, e, q,
                   base + static_cast<size_t>(slice) * kLanes, q0, Q, D,
                   c * kChunk);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_iter) load(s);
    cp_async_commit();
  }
  int c = 0;
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage it landed; stage it - 1 is free to refill
    if (it + kStages - 1 < n_iter) load(it + kStages - 1);
    cp_async_commit();
    compute<MQ>(es + (it % kStages) * kLanes * kChunk,
                qs + (it % kStages) * TQ * kChunk, warp, g, t, acc);
    if (++c == n_chunks) {  // the slice's sums are whole: fold them
      c = 0;
#pragma unroll
      for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            best[mt][nt][r] = max(best[mt][nt][r], acc[mt][nt][r]);
            acc[mt][nt][r] = 0;
          }
    }
  }

  // c0, c1: query 16mt + g, columns 2t, 2t + 1 of the n-tile; c2, c3: g + 8
#pragma unroll
  for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = j * kLanes + 32 * warp + 8 * nt + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qr = q0 + 16 * mt + g + 8 * h;
        if (qr < Q)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(qr) * out_ld +
                                     col) =
              make_float2(__int2float_rn(best[mt][nt][2 * h]),
                          __int2float_rn(best[mt][nt][2 * h + 1]));
      }
    }
}

template <int MQ>
int launch_tile(const int8_t* q, const int8_t* e, int Q, int D, int block,
                float* out, int nb, cudaStream_t st) {
  constexpr int kSmem = smem_bytes<MQ>();
  cudaError_t err = cudaFuncSetAttribute(
      int8_block_max_kernel<MQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  int8_block_max_kernel<MQ>
      <<<dim3(nb, (Q + 16 * MQ - 1) / (16 * MQ)), kThreads, kSmem, st>>>(
          q, e, Q, D, block, out, nb * kLanes);
  return cudaGetLastError();
}

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

int int8_block_max_i8(const int8_t* q, const int8_t* e, int Q, int N, int D,
                      int block, float* out, void* stream) {
  if (!floor_shape_ok(Q, N, D, block)) return cudaErrorInvalidValue;
  const int nb = N / block;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q <= 16) return launch_tile<1>(q, e, Q, D, block, out, nb, st);
  return launch_tile<4>(q, e, Q, D, block, out, nb, st);
}

// the plan's dynamic shared bytes, as the launch asks for them
int widen_sweep_smem(int nq, int stages, int resident, int chunks) {
  return widen_smem(nq, stages, resident != 0, chunks);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
