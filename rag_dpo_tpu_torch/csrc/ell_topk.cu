// ELL BM25 scoring + exact top-k for Hopper (sm_90a), with the reference's
// tie order.
//
// Replaces the Pallas TPU kernel rag_dpo_tpu/ops/sparse.py::ell_topk
// (_ell_topk_kernel, _ell_score_block) together with the streaming selector
// it calls, rag_dpo_tpu/ops/topk.py::streaming_topk_update and _rank_merge.
//
//   score[q, n] = sum_t w[q, t] * sum_l imp[n, l] * [term[n, l] == qterm[q, t]]
//
// summed in t order in f32 with the fused multiply-adds XLA's CPU compiler
// puts into the reference sum: fma(w0, h0, w1*h1), then fma(wt, ht, acc).
// Each (row, term) matches at most one slot, so every hit h is exact. A term
// the row lacks adds w·(+0), which leaves a non-zero sum as it is, so the
// kernel runs the chain over the matched terms only, in the order t = 1, 0,
// 2, 3, ... starting from +0 (fma(w1, h1, +0) is w1·h1 rounded): the same
// value for every finite weight and impact, a zero sum aside, whose sign the
// output drops (below). The scores agree bit for bit with the plain twin.
// Doc padding is term -1, query padding -2, so they never match.
//
// Tie order. The reference streams 1024-row blocks; per block it extracts the
// max of every 128-row segment round after round and rank-merges each round
// into the running top-k, earlier entries first. Equal scores therefore order
// by (1024-row block, round, segment), where a row's round is its rank inside
// its segment by (score desc, row asc). Zero-score rows stay ranked. That
// order is one 64-bit key a row, unique in a query: the score's bits made
// order-preserving (−0.0 as +0.0, which the reference's compare holds
// equal) above the complement of block·1024 + round·8 + segment, so that
// the larger key ranks first. The selections below sort keys, and the
// score written out is the key's: a −0.0 comes out +0.0, as the plain
// twin's sort gives it.
//
// Pass 1 (`ell_block_sort`), grid (blocks, Q), 1024 threads, thread i
// owning row block·1024 + i. Matching: the query's terms go to a 512-entry
// hash table in shared memory 32 at a time (a chunk of the t loop; a term
// repeated in the chunk lists its t in order). The block's slots are read
// in memory order, 16 bytes a thread where L % 4 == 0 and four loads in
// flight, so a warp's loads are coalesced (a thread reading its own row's
// slots made each warp load touch 32 lines, and that L1 traffic took 20 of
// a 27 µs block: evals/probe_ell.py); the impacts come in the same way,
// where loading a matched slot's impact alone cost a dependent load in a
// branch most warps took. A slot whose term is in the table adds its
// impact (a shared atomic add; a row holds a term once) to its row's hit of
// that t, a column of a [32][1024] shared array, and sets the t's bit in
// the row's mask; then each thread chains its own row.
// Selection: a bitonic sort of the block's 1024 keys, one a thread,
// exchanges below a warp through shuffles and above it through shared
// memory (15 of its 55 steps). Its first seven levels sort each segment by
// (score desc, row asc), the row in the key's low bits: a row's position
// there is its round, which completes its key (and a table of (segment,
// round) → row replaces the low bits); the last three merge the segments
// by the full key. The first min(k, 1024) keys are the block's top-k in the
// reference's order: with one block (N ≤ 1024, the hermetic replay's image)
// they are the output and there is no second launch; else they go to a
// scratch of [Q, blocks, min(k, 1024)] keys and ids.
//
// Pass 2 (`ell_merge`), one 1024-thread block a query. Where k ≤ 1024 and
// the blocks' lists fit in shared memory (9,216 keys), they merge in pairs,
// round after round, a merge-path search an output key, each merge cut to
// k. Else a candidate at position p of its block's list ranks p + the count
// of greater keys in each other block's list (binary searches of eight
// lists side by side, through the cache; the lists are sorted and the keys
// unique) and is written at that rank when it is below k. k has no bound
// but N rounded up to 1024.
//
// What bounds it on an H100: the bytes are a few MB (the serve shape's
// 17,408 × 32 slots: 1.3 µs at 3.35 TB/s), far below a launch; the work is
// a few hundred instructions a row and query, and its latency chains. The
// host sets each kernel's shared-memory size once a process and allocates
// the scratch only where there is a second pass.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockN = 1024;
constexpr int kSeg = 128;
constexpr int kTC = 32;            // query terms a chunk of the t loop
constexpr int kTable = 512;        // the chunk's hash table of terms
constexpr float kNegInf = -1e30f;
constexpr int kMergeStaged = 9216;  // candidates a query merged in shared
constexpr int kMergeIlp = 8;        // lists searched side by side

// pass 1's dynamic shared memory: the hits, each row's mask of matched t,
// the sort's double-buffered keys, each (segment, round)'s row, the
// chunk's terms and weights, the hash table (term, first t) and each t's
// next t of the same term
constexpr int kHitBytes = kTC * kBlockN * 4;
constexpr int kPass1Smem = kHitBytes + kBlockN * 4 + 2 * kBlockN * 8 +
                           kBlockN * 4 + 2 * kTC * 4 + 2 * kTable * 4 +
                           kTC * 4;

// the score's bits in an order that compares as the floats do, −0.0 as +0.0
__device__ __forceinline__ uint32_t score_order(float s) {
  uint32_t b = __float_as_uint(s);
  if (b == 0x80000000u) b = 0u;
  return b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
}

// the score of a key's upper half (−0.0 as +0.0)
__device__ __forceinline__ float key_score(uint64_t key) {
  const uint32_t o = static_cast<uint32_t>(key >> 32);
  return __uint_as_float(o ^ ((o >> 31) ? 0x80000000u : 0xffffffffu));
}

__device__ __forceinline__ int term_hash(int term) {
  return static_cast<int>((static_cast<uint32_t>(term) * 2654435761u) >> 23);
}

// Levels [lo, hi] of a bitonic sort of 1024 keys, one a thread, to
// descending order: at level `size`, pairs (i, i ^ stride) order down where
// bit `size` of i is clear, up where it is set.
__device__ __forceinline__ void bitonic_levels(int lo, int hi, uint64_t& key,
                                               uint64_t* kbuf, int& buf) {
  const int i = threadIdx.x;
  for (int size = lo; size <= hi; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      uint64_t ok;
      if (stride >= 32) {  // across warps: through shared memory
        kbuf[buf * kBlockN + i] = key;
        __syncthreads();
        ok = kbuf[buf * kBlockN + (i ^ stride)];
        buf ^= 1;  // the next shared step writes the other buffer
      } else {
        ok = __shfl_xor_sync(0xffffffffu, key, stride);
      }
      const bool down = (i & size) == 0, low = (i & stride) == 0;
      if (low == down ? ok > key : ok < key) key = ok;
    }
  }
}

// One slot of row `row` of the block: where its term is one of the chunk's,
// its impact is added to the row's hit of each t of that term, and the t's
// bit set in the row's mask. A row holds a term in one slot, so one add
// reaches a hit; two give the same sum in either order.
__device__ __forceinline__ void match_slot(int term, float imp, int row,
                                           const int* tab_term,
                                           const int* tab_t,
                                           const int* next_t, float* hits,
                                           uint32_t* masks) {
  if (term < 0) return;  // -1 padding matches nothing
  int h = term_hash(term);
  for (int e = tab_term[h]; e != -1; e = tab_term[h]) {
    if (e == term) {
      for (int t = tab_t[h]; t >= 0; t = next_t[t]) {
        atomicAdd(hits + t * kBlockN + row, imp);
        atomicOr(masks + row, 1u << t);
      }
      return;
    }
    h = (h + 1) & (kTable - 1);
  }
}

__global__ void __launch_bounds__(kBlockN, 1)
ell_block_sort(const int* __restrict__ terms,
               const float* __restrict__ impacts,
               const int* __restrict__ q_terms,
               const float* __restrict__ q_weights, int N, int L, int T,
               int k, int kb, int vec, uint64_t* __restrict__ cand_key,
               float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* hits = reinterpret_cast<float*>(smem);  // [kTC][kBlockN]
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + kHitBytes);
  uint64_t* kbuf = reinterpret_cast<uint64_t*>(masks + kBlockN);
  int* rowof = reinterpret_cast<int*>(kbuf + 2 * kBlockN);  // [seg][round]
  int* ct = rowof + kBlockN;                          // the chunk's terms
  float* cw = reinterpret_cast<float*>(ct + kTC);     // and weights
  int* tab_term = reinterpret_cast<int*>(cw + kTC);   // -1: empty
  int* tab_t = tab_term + kTable;
  int* next_t = tab_t + kTable;

  const int blk = blockIdx.x, q = blockIdx.y, nb = gridDim.x;
  const int tid = threadIdx.x;
  const bool live = blk * kBlockN + tid < N;
  // the block's live rows are contiguous: the slots are read in their
  // memory order, a warp's loads coalesced
  const int n_slots = max(0, min(kBlockN, N - blk * kBlockN)) * L;
  const size_t base = static_cast<size_t>(blk) * kBlockN * L;
  const int* bt = terms + base;
  const float* bi = impacts + base;
  float acc = 0.f;
  for (int t0 = 0; t0 < T; t0 += kTC) {
    const int tn = min(kTC, T - t0);
    __syncthreads();  // the last chunk's table and hits are read
    if (tid < tn) {
      ct[tid] = q_terms[static_cast<size_t>(q) * T + t0 + tid];
      cw[tid] = q_weights[static_cast<size_t>(q) * T + t0 + tid];
    }
    for (int e = tid; e < kTable; e += kBlockN) tab_term[e] = -1;
    for (int t = 0; t < tn; ++t) hits[t * kBlockN + tid] = 0.f;
    masks[tid] = 0u;
    __syncthreads();
    if (tid < tn) {  // the chunk's terms into the table; -2 padding stays out
      const int term = ct[tid];
      bool head = term >= 0;  // the first t of its term
      int next = -1;          // the next t of the same term
      for (int u = 0; u < tn; ++u) {
        if (ct[u] != term) continue;
        head = head && u >= tid;
        if (u > tid && next < 0) next = u;
      }
      next_t[tid] = next;
      if (head) {  // heads hold distinct terms: one slot each
        int h = term_hash(term);
        while (atomicCAS(tab_term + h, -1, term) != -1)
          h = (h + 1) & (kTable - 1);
        tab_t[h] = tid;
      }
    }
    __syncthreads();
    if (vec) {  // 16-byte loads of four slots of one row, terms and
                // impacts, four of each in flight
      const int4* bt4 = reinterpret_cast<const int4*>(bt);
      const float4* bi4 = reinterpret_cast<const float4*>(bi);
      for (int i0 = tid; i0 < n_slots / 4; i0 += 4 * kBlockN) {
        int4 v[4];
        float4 w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * kBlockN;
          const bool in = i < n_slots / 4;
          v[u] = in ? __ldg(bt4 + i) : make_int4(-1, -1, -1, -1);
          w[u] = in ? __ldg(bi4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int row = 4 * (i0 + u * kBlockN) / L;
          match_slot(v[u].x, w[u].x, row, tab_term, tab_t, next_t, hits,
                     masks);
          match_slot(v[u].y, w[u].y, row, tab_term, tab_t, next_t, hits,
                     masks);
          match_slot(v[u].z, w[u].z, row, tab_term, tab_t, next_t, hits,
                     masks);
          match_slot(v[u].w, w[u].w, row, tab_term, tab_t, next_t, hits,
                     masks);
        }
      }
    } else {
      for (int e = tid; e < n_slots; e += kBlockN)
        match_slot(__ldg(bt + e), __ldg(bi + e), e / L, tab_term, tab_t,
                   next_t, hits, masks);
    }
    __syncthreads();
    // the t-order chain of row tid over its matched terms only: an
    // unmatched t adds w·(+0) to the sum, which leaves a non-zero sum as it
    // is (a zero sum keeps its value, and the key and the output hold ±0 as
    // +0); the chain starts with w1·h1, then fma(w0, h0, ·), then t = 2, 3
    uint32_t mask = masks[tid];
    const float* my_hits = hits + tid;
    if (t0 == 0) {
      if (mask & 2u) acc = __fmaf_rn(cw[1], my_hits[kBlockN], acc);
      if (mask & 1u) acc = __fmaf_rn(cw[0], my_hits[0], acc);
      mask &= ~3u;
    }
    while (mask) {
      const int t = __ffs(mask) - 1;
      mask &= mask - 1;
      acc = __fmaf_rn(cw[t], my_hits[t * kBlockN], acc);
    }
  }
  const float score = live ? acc : kNegInf;

  // each segment by (score desc, row asc): a row's position is its round
  uint64_t key = (static_cast<uint64_t>(score_order(score)) << 32) |
                 static_cast<uint32_t>(kBlockN - 1 - tid);
  int buf = 0;
  bitonic_levels(2, kSeg, key, kbuf, buf);
  const int seg = tid / kSeg, pos = tid % kSeg;
  const int rnd = (seg & 1) ? kSeg - 1 - pos : pos;  // odd segments sort up
  rowof[seg * kSeg + rnd] = kBlockN - 1 - static_cast<int>(key & 0x3ffu);
  const uint32_t tie = static_cast<uint32_t>(blk) * kBlockN +
                       rnd * (kBlockN / kSeg) + seg;
  key = (key & 0xffffffff00000000ull) | (0xffffffffu - tie);
  bitonic_levels(2 * kSeg, kBlockN, key, kbuf, buf);  // syncs: rowof is in

  if (tid < kb) {  // the block's top-kb, in order
    const uint32_t t = 0xffffffffu - static_cast<uint32_t>(key);
    const int r = blk * kBlockN +
                  rowof[(t % (kBlockN / kSeg)) * kSeg +
                        (t % kBlockN) / (kBlockN / kSeg)];
    const int id = r < N ? r : -1;
    if (nb == 1) {
      out_s[static_cast<size_t>(q) * k + tid] = key_score(key);
      out_i[static_cast<size_t>(q) * k + tid] = id;
    } else {
      const size_t m = static_cast<size_t>(nb) * kb;
      const size_t at = static_cast<size_t>(q) * m +
                        static_cast<size_t>(blk) * kb + tid;
      const size_t total = static_cast<size_t>(gridDim.y) * m;
      cand_key[at] = key;
      reinterpret_cast<int*>(cand_key + total)[at] = id;
    }
  }
}

// A candidate's rank: its position in its list plus, for each other list,
// the count of keys above it (a binary search; the lists are descending
// and the keys unique), kMergeIlp lists at a time; stops past k.
__device__ __forceinline__ int merge_rank(const uint64_t* keys, int nb, int kb,
                                          int list, int pos, uint64_t x,
                                          int k) {
  int rank = pos;
  for (int o0 = 0; o0 < nb && rank < k; o0 += kMergeIlp) {
    int lo[kMergeIlp], len[kMergeIlp];
#pragma unroll
    for (int j = 0; j < kMergeIlp; ++j) {
      lo[j] = (o0 + j) * kb;
      len[j] = o0 + j < nb && o0 + j != list ? kb : 0;
    }
    for (int left = kb; left > 0; left >>= 1) {  // ⌊log2 kb⌋ + 1 steps
#pragma unroll
      for (int j = 0; j < kMergeIlp; ++j) {
        if (len[j] > 0) {
          const int half = len[j] >> 1;
          if (keys[lo[j] + half] > x) {
            lo[j] += half + 1;
            len[j] -= half + 1;
          } else {
            len[j] = half;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMergeIlp; ++j)
      if (o0 + j < nb && o0 + j != list) rank += lo[j] - (o0 + j) * kb;
  }
  return rank;
}

// The i-th key (and id) of the descending merge of lists a and b of len
// keys each: a merge-path search for how many of the first i come from a.
__device__ __forceinline__ void merge_path(const uint64_t* ak, const int* ai,
                                           const uint64_t* bk, const int* bi,
                                           int len, int i, uint64_t& key,
                                           int& id) {
  int lo = max(0, i - len), hi = min(i, len);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ak[mid] > bk[i - 1 - mid])
      lo = mid + 1;
    else
      hi = mid;
  }
  const int j = i - lo;
  const bool from_a = j >= len || (lo < len && ak[lo] > bk[j]);
  key = from_a ? ak[lo] : bk[j];
  id = from_a ? ai[lo] : bi[j];
}

// Pass 2, a block a query. Where every block's list holds k keys (k ≤ 1024)
// and they fit in shared memory, the lists merge in pairs, round after
// round (a merge path a key), each merge cut to its first k; else each
// candidate is ranked against the other lists (`merge_rank`).
__global__ void __launch_bounds__(kBlockN)
ell_merge(const uint64_t* __restrict__ cand_key, int nb, int kb, int Q,
          int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x, m = nb * kb;
  const size_t total = static_cast<size_t>(Q) * m;
  const uint64_t* keys = cand_key + static_cast<size_t>(q) * m;
  const int* ids = reinterpret_cast<const int*>(cand_key + total) +
                   static_cast<size_t>(q) * m;
  float* os = out_s + static_cast<size_t>(q) * k;
  int* oi = out_i + static_cast<size_t>(q) * k;
  if (kb == k && m <= kMergeStaged) {
    uint64_t* ka = reinterpret_cast<uint64_t*>(smem);  // two buffers
    int* ia = reinterpret_cast<int*>(ka + 2 * kMergeStaged);
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      ka[i] = keys[i];
      ia[i] = ids[i];
    }
    int lists = nb, from = 0;
    while (lists > 1) {
      __syncthreads();
      const int pairs = lists / 2, next = lists - pairs;
      const int to = kMergeStaged - from;
      for (int o = threadIdx.x; o < next * k; o += blockDim.x) {
        const int j = o / k, i = o - j * k;
        uint64_t key;
        int id;
        if (j < pairs) {
          const int a = from + 2 * j * k, b = a + k;
          merge_path(ka + a, ia + a, ka + b, ia + b, k, i, key, id);
        } else {  // the odd list out, as it is
          key = ka[from + 2 * j * k + i];
          id = ia[from + 2 * j * k + i];
        }
        ka[to + o] = key;
        ia[to + o] = id;
      }
      lists = next;
      from = to;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      os[i] = key_score(ka[from + i]);
      oi[i] = ia[from + i];
    }
    return;
  }
  for (int idx = threadIdx.x; idx < m; idx += blockDim.x) {
    const int list = idx / kb;
    const uint64_t x = keys[idx];
    const int rank = merge_rank(keys, nb, kb, list, idx - list * kb, x, k);
    if (rank < k) {
      os[rank] = key_score(x);
      oi[rank] = ids[idx];
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// terms/impacts [N, L]; q_terms/q_weights [Q, T]; out_* [Q, k]; scratch
// of ell_topk_scratch_bytes(N, Q, k) bytes, unused (may be null) where N ≤
// 1024. Needs T >= 1 and 1 <= k <= N rounded up to 1024. Returns a
// cudaError_t.
int ell_topk(const int* terms, const float* impacts, const int* q_terms,
             const float* q_weights, int N, int L, int Q, int T, int k,
             void* scratch, float* out_s, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (N + kBlockN - 1) / kBlockN;
  if (N <= 0 || L < 0 || Q <= 0 || T <= 0 || k <= 0 ||
      static_cast<long long>(k) > static_cast<long long>(nb) * kBlockN ||
      (nb > 1 && scratch == nullptr))
    return cudaErrorInvalidValue;
  static bool sized = false;  // both kernels' shared-memory bound, once
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        ell_block_sort, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kPass1Smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ell_merge,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMergeStaged * 24);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const int kb = k < kBlockN ? k : kBlockN;
  const int vec = L % 4 == 0 && reinterpret_cast<uintptr_t>(terms) % 16 == 0;
  uint64_t* cand = static_cast<uint64_t*>(scratch);
  ell_block_sort<<<dim3(nb, Q), kBlockN, kPass1Smem, st>>>(
      terms, impacts, q_terms, q_weights, N, L, T, k, kb, vec, cand, out_s,
      out_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nb == 1) return err;
  const bool staged = kb == k && nb * kb <= kMergeStaged;
  ell_merge<<<Q, kBlockN, staged ? kMergeStaged * 24 : 0, st>>>(
      cand, nb, kb, Q, k, out_s, out_i);
  return cudaGetLastError();
}

// the scratch pass 1 hands to pass 2: a key and an id for each of the Q ·
// blocks · min(k, 1024) candidates; 0 for one block
long long ell_topk_scratch_bytes(int N, int Q, int k) {
  const long long nb = (N + kBlockN - 1) / kBlockN;
  return nb > 1 ? 12ll * Q * nb * (k < kBlockN ? k : kBlockN) : 0;
}

// n launches of an empty kernel: the card's launch-to-launch floor
int empty_launches(int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) empty_kernel<<<1, 32, 0, st>>>();
  return cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
