// The int8-widening tensor-core product that the int8 sweeps share:
// csrc/pooled.cu (K6, bf16 queries against int8 rows with scales, a
// penalty and the first argmax of each strided group) and the bf16 path of
// csrc/int8_block_max.cu (K10, int8 queries widened to bf16, the max of
// each strided column group). One product, two epilogues.
//
// Both kernels sweep int8 rows [N, D] cut into blocks of block_n rows; a
// block holds ng = block_n / group strided groups, group g being rows
// j·block_n + a·ng + g for the layers a in [0, group) (K10: ng 128, group
// block / 128). A tile is one layer of 128 consecutive groups [g0, g0 +
// 128): rows j·block_n + a·ng + g0 + r for r < 128. A work item is one
// (block j, g0); its tiles walk the layers a = 0, 1, ..., so each lane
// keeps the running max of its (group, query) cells over the layers in
// registers.
//
// The product of a tile runs as wgmma.mma_async m64nNQk16 (bf16 in, f32
// sums) with A from registers: the tile's rows are the M side (64 a
// warpgroup, two warpgroups), the NQ queries (16 or 64) the N side, in
// 128-byte-swizzled shared memory. D goes in 128-byte chunks: a producer
// warp fills a ring with TMA (a box of 128 rows × 128 bytes a stage, and
// for streamed queries two boxes of 64 columns × NQ; full and empty
// mbarriers a slot), and each consumer lane loads the bytes of its A
// fragments, [16t, 16t + 16) of each 64-byte half of its rows g and g + 8,
// and widens them exactly to bf16 in registers (bf16_pair): every int8 row
// element is widened once a block, by the one lane that multiplies it, and
// never goes back to shared memory. Word s of those 16 bytes fills the k
// slots of k step s: bytes 16t + 4s + (0, 1) the slots 2t, 2t + 1 and
// bytes (2, 3) the slots 2t + 8, 2t + 9, so the queries' columns go in the
// same order (`query_col`): K6 gets a permuted copy of its queries from the
// wrapper, K10 widens its int8 queries once a block into that order.
//
// The warpgroups run independently (no block barrier in the loop): while
// one widens, the other's products run; at NQ 16 each spreads its k steps
// over four accumulators, summed in order at the tile's end.
// Nothing is atomic and the k steps go in a fixed order, so two runs give
// the same bits. bf16 × bf16 and bf16 × (int8 widened) products are exact
// in f32; the tensor cores sum them in their own order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_product.cuh"  // TMA, mbarriers, sw128_desc, the wgmma fences

namespace {

constexpr int kWTileRows = 128;  // rows of e a tile: two warpgroups' M
constexpr int kWChunk = 128;     // D a stage: 128 int8 bytes of a row
constexpr int kWConsumers = 256;
constexpr int kWThreads = kWConsumers + 32;  // + the producer warp
constexpr int kWRowStage = kWTileRows * kWChunk;  // int8 rows, 16 KB
constexpr int kWBars = 128;                       // the ring's mbarriers
constexpr int kWMaxStages = 8;
constexpr int kWMaxSmem = 232448;

// the query tile's bf16 bytes a chunk (two 64-column slices of NQ rows)
__host__ __device__ constexpr int widen_q_chunk(int nq) { return nq * 256; }

// dynamic shared bytes of a plan; the 1024-byte alignment slack counted
__host__ __device__ constexpr int widen_smem(int nq, int stages,
                                             bool resident, int chunks) {
  return kSmemAlign +
         stages * (kWRowStage + (resident ? 0 : widen_q_chunk(nq))) +
         (resident ? chunks * widen_q_chunk(nq) : 0) + kWBars;
}

// Bytes (2h, 2h + 1) of w, signed int8, as bf16x2 (byte 2h in the low
// half), exactly: with l = b & 0x7f, the bf16 0x43|l is 128 + l, and the
// bf16 0x4380 (256) where b < 0, else 0x4300 (128), subtracted from it
// gives b (l − 128 or l), an integer that bf16 holds.
__device__ __forceinline__ uint32_t bf16_pair(uint32_t w, int h) {
  const uint32_t x = __byte_perm(w, 0x43434343u, h ? 0x5352 : 0x5150);
  uint32_t mag = x & 0xff7fff7fu;
  uint32_t sub = (x & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 d = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&mag),
                             *reinterpret_cast<__nv_bfloat162*>(&sub));
  return *reinterpret_cast<uint32_t*>(&d);
}

// where 16-byte unit u of row r of a 128-byte-row tile sits (the 128-byte
// swizzle TMA writes: rows 8 apart repeat the pattern; tiles 1024-aligned)
__device__ __forceinline__ int wswz(int r, int u) {
  return 16 * (u ^ (r & 7));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// word i of a 16-byte fragment piece
__device__ __forceinline__ uint32_t word_of(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// The column (within its 64-column slice, as the products read it) of the
// query element at column d: d = 64b + 16t + 4s + j goes to k step s, slot
// 2t + (j & 1) + 8·(j >> 1), as the lanes fill their A fragments.
__host__ __device__ constexpr int query_col(int d) {
  return 16 * ((d >> 2) & 3) + 2 * ((d >> 4) & 3) + (d & 1) +
         8 * ((d >> 1) & 1);
}

// D += A·Bᵀ for one k16 step: A [64 rows × 16] bf16 from registers (the
// m16n8k16 fragment of each warp), B [N × 16] K-major in shared memory, D
// [64 × N] f32 in the warpgroup's registers
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
        "0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

struct WidenArgs {
  const void* q;  // [Q, D]: bf16, columns in query_col order (K6), or int8
  const int8_t* e;
  int Q, N, D, block_n, group, ng;
  int n_gchunks, n_items;  // items: blocks × ceil(ng / 128)
  int walkers, qtiles, stages;
};

// Where a walker is in its iterations: its k-th item (block j, groups from
// g0), the tile's layer a and the chunk c; advanced one chunk at a time, so
// no iteration divides.
struct WidenCursor {
  int k, j, g0, a, c;

  __device__ __forceinline__ void enter(const WidenArgs& w, int walker) {
    const int item = walker + k * w.walkers;
    j = item / w.n_gchunks;
    g0 = (item - j * w.n_gchunks) * kWTileRows;
  }
  __device__ __forceinline__ void start(const WidenArgs& w, int walker) {
    k = 0; a = 0; c = 0;
    enter(w, walker);
  }
  __device__ __forceinline__ void advance(const WidenArgs& w, int walker,
                                          int chunks) {
    if (++c < chunks) return;
    c = 0;
    if (++a < w.group) return;
    a = 0;
    ++k;
    enter(w, walker);
  }
  // the row of e of the tile's row r
  __device__ __forceinline__ size_t row(const WidenArgs& w, int r) const {
    return static_cast<size_t>(j) * w.block_n +
           static_cast<size_t>(a) * w.ng + g0 + r;
  }
};

// The ring in dynamic shared memory, 1024-aligned: `stages` slots (a box of
// 128 rows × 128 bytes, then the streamed queries' boxes), the resident
// query tile, then the full and the empty mbarrier of each slot. K6, K10
// and K11 (csrc/int8_block_max.cu) share it and its producer.
struct WidenRing {
  uint8_t* slots;
  uint8_t* resident_q;
  uint64_t* full;
  uint64_t* empty;
  int stage_bytes;

  __device__ __forceinline__ uint8_t* slot(int s) const {
    return slots + s * stage_bytes;
  }
};

__device__ __forceinline__ WidenRing widen_ring(uint8_t* raw, int stages,
                                                int q_stage_bytes,
                                                int resident_bytes) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(raw);
  WidenRing r;
  r.slots = raw + ((kSmemAlign - (at & (kSmemAlign - 1))) & (kSmemAlign - 1));
  r.stage_bytes = kWRowStage + q_stage_bytes;
  r.resident_q = r.slots + stages * r.stage_bytes;
  r.full = reinterpret_cast<uint64_t*>(r.resident_q + resident_bytes);
  r.empty = r.full + kWMaxStages;
  return r;
}

// thread 0: a full barrier a slot counts the producer's arrival and the
// bytes in, an empty one the eight consumer warps out
__device__ __forceinline__ void widen_ring_init(const WidenRing& r,
                                                int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(r.full + s, 1);
      mbar_init(r.empty + s, kWConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// The producer (lane 0 of the warp after the consumers): n_iter chunks in
// the cursor's order, each the box of 128 rows at cur.row(w, 0) (none for
// a tile wholly past N: zeros) and QBoxes boxes of QBoxBytes of the query
// tile's rows from q0, 64 columns apart (K6: two of bf16, the second only
// where D reaches it; K11 streamed: one of int8; resident: none). The
// cursor has the members `c` (the chunk) and row(w, r), advance(w, walker,
// chunks).
template <int QBoxes, int QBoxBytes, class Cursor>
__device__ __forceinline__ void widen_produce(const WidenRing& r,
                                              const WidenArgs& w,
                                              const CUtensorMap* map_e,
                                              const CUtensorMap* map_q,
                                              Cursor cur, int walker,
                                              int n_iter, int chunks,
                                              int q0) {
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % w.stages;
    mbar_wait(r.empty + s, ((it / w.stages) & 1) ^ 1);
    uint8_t* dst = r.slot(s);
    const size_t row = cur.row(w, 0);
    const bool rows_in = row < static_cast<size_t>(w.N);
    const int n_q = QBoxes == 2 ? 1 + (cur.c * kWChunk + 64 < w.D) : QBoxes;
    mbar_expect_tx(r.full + s,
                   (rows_in ? kWRowStage : 0) + n_q * QBoxBytes);
    if (rows_in)  // zeros past D and N; a tile wholly past N: no box
      tma_load_2d(dst, map_e, r.full + s, cur.c * kWChunk,
                  static_cast<int>(row));
#pragma unroll
    for (int h = 0; h < QBoxes; ++h)
      if (h < n_q)
        tma_load_2d(dst + kWRowStage + h * QBoxBytes, map_q, r.full + s,
                    cur.c * kWChunk + 64 * h, q0);
    cur.advance(w, walker, chunks);
  }
}

// The sweep, by kWThreads threads: consumer warpgroups 0 and 1 (tile rows
// 64·wg ...), the producer warp after them. The epilogue Epi (K6's or
// K10's) supplies the tile's fold and the item's output:
//   Epi::kInt8Queries               int8 queries, resident (widened once a
//                                   block); else bf16, in the ring
//   epi.reset()                     the running maxima's start
//   epi.tile_start(w, cur, r0)      the tile's first chunk (K6: its rows'
//                                   scales and penalties)
//   epi.fold(acc, a)                the tile's sums, layer a
//   epi.write(w, cur, r0, q0)       the item's maxima
// r0 is the lane's first tile row (64·wg + 16·warp + g; the other is
// r0 + 8).
template <int NQ, class Epi>
__device__ __forceinline__ void widen_sweep(const WidenArgs& w,
                                            const CUtensorMap* map_e,
                                            const CUtensorMap* map_q,
                                            Epi& epi) {
  constexpr int kQChunk = widen_q_chunk(NQ);
  constexpr bool kResident = Epi::kInt8Queries;
  extern __shared__ __align__(16) uint8_t widen_raw[];
  const int chunks = (w.D + kWChunk - 1) / kWChunk;
  const WidenRing ring = widen_ring(widen_raw, w.stages,
                                    kResident ? 0 : kQChunk,
                                    kResident ? chunks * kQChunk : 0);
  uint8_t* const resident_q = ring.resident_q;

  const int tid = threadIdx.x;
  const int qtile = blockIdx.x % w.qtiles, walker = blockIdx.x / w.qtiles;
  const int q0 = qtile * NQ;
  const int n_my =
      walker < w.n_items ? (w.n_items - 1 - walker) / w.walkers + 1 : 0;
  const int n_iter = n_my * w.group * chunks;
  if (n_iter == 0) return;

  widen_ring_init(ring, w.stages);
  // resident (int8) queries: the query tile widened once a block, its
  // columns in query_col order, by the consumers
  if (kResident && tid < kWConsumers) {
    const int8_t* q = static_cast<const int8_t*>(w.q);
    for (int v = tid; v < chunks * NQ * 8; v += kWConsumers) {
      const int c = v / (NQ * 8), rem = v - c * NQ * 8;
      const int qr = rem >> 3, p = rem & 7, d = c * kWChunk + 16 * p;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + qr < w.Q && d < w.D)
        x = __ldg(reinterpret_cast<const uint4*>(
            q + static_cast<size_t>(q0 + qr) * w.D + d));
      // piece p: slice p >> 2, lane slot t = p & 3; word s fills k step s
      uint8_t* row = resident_q + c * kQChunk + (p >> 2) * NQ * 128 + qr * 128;
      const int t = p & 3;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint32_t wd = word_of(x, s);
        *reinterpret_cast<uint32_t*>(row + wswz(qr, 2 * s) + 4 * t) =
            bf16_pair(wd, 0);
        *reinterpret_cast<uint32_t*>(row + wswz(qr, 2 * s + 1) + 4 * t) =
            bf16_pair(wd, 1);
      }
    }
    fence_proxy_async();
  }
  __syncthreads();

  if (tid >= kWConsumers) {  // the producer warp: lane 0 fills the ring
    if (tid != kWConsumers) return;
    WidenCursor cur;
    cur.start(w, walker);
    widen_produce<kResident ? 0 : 2, NQ * 128>(ring, w, map_e, map_q, cur,
                                               walker, n_iter, chunks, q0);
    return;
  }

  // the consumers
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * warp + g;  // the lane's rows r0, r0 + 8
  // independent accumulators, k step k into acc[k % NACC]: a chain of
  // wgmma into one accumulator waits out each product's latency, which an
  // m64n16k16 product does not cover; at NQ 64 a second accumulator costs
  // more in registers than it saves (evals/probe_widen.py)
  constexpr int NACC = NQ == 16 ? 4 : 1;
  WidenCursor cur;
  cur.start(w, walker);
  float acc[NACC][NQ / 2];
  epi.reset();
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % w.stages;
    if (cur.c == 0) {
#pragma unroll
      for (int n = 0; n < NACC; ++n)
#pragma unroll
        for (int i = 0; i < NQ / 2; ++i) acc[n][i] = 0.f;
      epi.tile_start(w, cur, r0);
    }
    mbar_wait(ring.full + s, (it / w.stages) & 1);
    const uint8_t* rows = ring.slot(s);
    uint4 x[2][2];  // [half][row r0, r0 + 8]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = r0 + 8 * rr;
        x[h][rr] = *reinterpret_cast<const uint4*>(rows + r * 128 +
                                                   wswz(r, 4 * h + t));
      }
    uint32_t af[8][4];  // k step 4h + k: the A fragment, widened
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t w0 = word_of(x[h][0], k), w1 = word_of(x[h][1], k);
        af[4 * h + k][0] = bf16_pair(w0, 0);
        af[4 * h + k][1] = bf16_pair(w1, 0);
        af[4 * h + k][2] = bf16_pair(w0, 1);
        af[4 * h + k][3] = bf16_pair(w1, 1);
      }
    const uint8_t* qs = kResident ? resident_q + cur.c * kQChunk
                                   : rows + kWRowStage;
    const uint64_t db0 = sw128_desc(qs), db1 = sw128_desc(qs + NQ * 128);
#pragma unroll
    for (int n = 0; n < NACC; ++n) fence_acc(acc[n]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      WgmmaRS<NQ>::mma(acc[k % NACC], af[k], db0 + 2 * k);
    if (cur.c * kWChunk + 64 < w.D) {  // the chunk's second half
#pragma unroll
      for (int k = 4; k < 8; ++k)
        WgmmaRS<NQ>::mma(acc[k % NACC], af[k], db1 + 2 * (k - 4));
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < NACC; ++n) fence_acc(acc[n]);
    if (lane == 0) mbar_arrive(ring.empty + s);  // the slot's bytes are read
    if (cur.c == chunks - 1) {  // the tile's sums are whole
#pragma unroll
      for (int n = 1; n < NACC; ++n)
#pragma unroll
        for (int i = 0; i < NQ / 2; ++i) acc[0][i] += acc[n][i];
      epi.fold(acc[0], cur.a);
      if (cur.a == w.group - 1) {  // the item's last layer
        epi.write(w, cur, r0, q0);
        epi.reset();
      }
    }
    cur.advance(w, walker, chunks);
  }
}

// the lanes' view of a warpgroup's m64nNQ accumulator: acc[i] is tile row
// r0 + acc_row(i) and query column q0 + acc_query(i, t)
__device__ __forceinline__ int acc_row(int i) { return 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int acc_query(int i, int t) {
  return 8 * (i >> 2) + 2 * t + (i & 1);
}

// The map of a [rows, D] row-major int8 matrix read in boxes of box_rows
// (128: a tile of rows; K11's streamed queries: its NQ) × 128 bytes,
// 128-byte swizzled (the layout `wswz` reads), zeros outside. D % 16 == 0
// and a 16-byte-aligned pointer.
inline cudaError_t int8_rows_map(CUtensorMap* map, const void* ptr, int rows,
                                 int D, int box_rows = kWTileRows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D)};
  const cuuint32_t box[2] = {kWChunk, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the grid: walkers per query tile, so that walkers × qtiles fill the
// card's SMs once (one block an SM: every plan takes over half of its
// shared memory); the query tiles of a walker are neighbours in the grid
inline int widen_walkers(int n_items, int qtiles) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  const int walkers = (sms + qtiles - 1) / qtiles;
  return walkers > n_items ? n_items : walkers;
}

// a plan the kernels take: 16 or 64 queries a block, 2 to 8 stages, within
// the block's shared memory
inline bool widen_plan_ok(int nq, int stages, bool resident, int chunks) {
  return (nq == 16 || nq == 64) && stages >= 2 && stages <= kWMaxStages &&
         widen_smem(nq, stages, resident, chunks) <= kWMaxSmem;
}

}  // namespace
