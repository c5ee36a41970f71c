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
// Each (row, term) matches at most one slot, so every hit h is exact, and
// the scores agree bit for bit with the reference and the plain twin.
// Doc padding is term -1, query padding -2, so they never match.
//
// Tie order. The reference streams 1024-row blocks; per block it extracts the
// max of every 128-row segment round after round and rank-merges each round
// into the running top-k, earlier entries first. Equal scores therefore order
// by (1024-row block, round, segment), where a row's round is its rank inside
// its segment by (score desc, row asc). Zero-score rows stay ranked.
//
// Pass 1, grid (blocks, Q), 1024 threads: thread i scores row block*1024 + i,
// computes its round against its segment and its rank in the block by
// (-score, round, segment), and the rows ranked below kb = min(k, 1024)
// write the block's sorted top-kb. Pass 2, one warp a query: the final
// order is by (-score, block, rank in block), i.e. by (-score, position in
// the candidate list), so K4's running top-k merge (csrc/topk_merge.cuh)
// with the position as the key selects it, streaming the candidates from
// global memory; its list stays in shared memory up to k ~3,500 and
// otherwise in the query's output row, so k has no bound. Rows past N
// score -1e30 and carry id -1, like the reference's empty slots.
//
// What bounds it on an H100: each thread reads its row's L slots once (a
// strided, uncoalesced read; re-reading them once per query term made the
// first version L1-bound at 0.66 ms), compares each against the T query
// terms in shared memory, and ranks its row with O(1024) shared-memory
// compares. Only ceil(N/1024)*Q blocks run, fewer than the 132 SMs at the
// deployed corpus size (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_merge.cuh"

namespace {

constexpr int kBlockN = 1024;
constexpr int kSeg = 128;
constexpr int kMaxT = 64;  // query terms matched per pass over a row
constexpr float kNegInf = -1e30f;
constexpr int kMergeWarps = 8;  // pass 2: queries a block
constexpr int kMaxSmem = 232448;

__global__ void __launch_bounds__(kBlockN)
ell_block_topk(const int* __restrict__ terms, const float* __restrict__ impacts,
               const int* __restrict__ q_terms,
               const float* __restrict__ q_weights, int N, int L, int T, int kb,
               float* __restrict__ cand_s, int* __restrict__ cand_i) {
  __shared__ float s_sh[kBlockN];
  __shared__ int round_sh[kBlockN];
  extern __shared__ unsigned char dyn[];
  int* qt_sh = reinterpret_cast<int*>(dyn);
  float* qw_sh = reinterpret_cast<float*>(dyn + sizeof(int) * T);

  const int blk = blockIdx.x, q = blockIdx.y, nb = gridDim.x;
  const int tid = threadIdx.x;
  const int n = blk * kBlockN + tid;
  for (int t = tid; t < T; t += kBlockN) {
    qt_sh[t] = q_terms[static_cast<size_t>(q) * T + t];
    qw_sh[t] = q_weights[static_cast<size_t>(q) * T + t];
  }
  __syncthreads();

  float score = kNegInf;
  if (n < N) {
    // each slot is read once per chunk of kMaxT query terms and matched
    // against the chunk's terms; the per-term hits go to a thread-local
    // array so the sum below runs in t order, one chunk after the other
    const int* rt = terms + static_cast<size_t>(n) * L;
    const float* ri = impacts + static_cast<size_t>(n) * L;
    float acc = 0.f;
    // (the t loops unroll by 4: rolled, they took 8% longer at T 32;
    // unrolled to their bound of 64, a predicated compare per slot and
    // term, twice K3's time)
    for (int t0 = 0; t0 < T; t0 += kMaxT) {
      const int tn = min(kMaxT, T - t0);
      float hit[kMaxT];
#pragma unroll 4
      for (int t = 0; t < tn; ++t) hit[t] = 0.f;
      for (int l = 0; l < L; ++l) {
        const int term = __ldg(rt + l);
        if (term < 0) continue;  // -1 padding matches no query term
        const float imp = __ldg(ri + l);
#pragma unroll 4
        for (int t = 0; t < tn; ++t)
          if (qt_sh[t0 + t] == term) hit[t] = __fadd_rn(hit[t], imp);
      }
      int t = 0;
      if (t0 == 0) {
        acc = __fmul_rn(qw_sh[0], hit[0]);
        if (T > 1)
          acc = __fmaf_rn(qw_sh[0], hit[0], __fmul_rn(qw_sh[1], hit[1]));
        t = 2;
      }
#pragma unroll 4
      for (; t < tn; ++t) acc = __fmaf_rn(qw_sh[t0 + t], hit[t], acc);
    }
    score = acc;
  }
  s_sh[tid] = score;
  __syncthreads();

  const int seg = tid / kSeg, lane = tid % kSeg;
  const float* seg_s = s_sh + seg * kSeg;
  int rnd = 0;
  for (int j = 0; j < kSeg; ++j) {
    const float o = seg_s[j];
    rnd += (o > score) || (o == score && j < lane);
  }
  round_sh[tid] = rnd;
  __syncthreads();

  int rank = 0;
  for (int j = 0; j < kBlockN; ++j) {
    const float o = s_sh[j];
    if (o > score) {
      ++rank;
    } else if (o == score) {
      const int orr = round_sh[j];
      rank += orr < rnd || (orr == rnd && j / kSeg < seg);
    }
  }
  if (rank < kb) {
    const size_t off = (static_cast<size_t>(q) * nb + blk) * kb + rank;
    cand_s[off] = score;
    cand_i[off] = n < N ? n : -1;
  }
}

__global__ void __launch_bounds__(kMergeWarps * 32)
ell_merge(const float* __restrict__ cand_s, const int* __restrict__ cand_i,
          int m, int Q, int k, int list_in_smem, float* out_s, int* out_i) {
  extern __shared__ float4 smem4[];
  float* ps = reinterpret_cast<float*>(smem4);          // [warps][128]
  int* pi = reinterpret_cast<int*>(ps + kMergeWarps * kMergeN);
  float* ls = reinterpret_cast<float*>(pi + kMergeWarps * kMergeN);
  int* lp = reinterpret_cast<int*>(ls + kMergeWarps * k);  // [warps][k]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kMergeWarps + warp;
  if (q >= Q) return;  // whole warps leave; no block barrier follows
  const size_t row = static_cast<size_t>(q) * k;
  float* wl = list_in_smem ? ls + static_cast<size_t>(warp) * k : out_s + row;
  int* wp = list_in_smem ? lp + static_cast<size_t>(warp) * k : out_i + row;
  const float* cs = cand_s + static_cast<size_t>(q) * m;
  int cnt = 0;
  float ts = -INFINITY;
  int ti = 0x7fffffff;
  for (int base = 0; base < m; base += kMergeN) {
    float s[kPer];
    int pos[kPer];
    bool ok[kPer];
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      pos[t] = base + t * 32 + lane;
      ok[t] = pos[t] < m;
      s[t] = ok[t] ? cs[pos[t]] : -INFINITY;
    }
    cnt = filter_merge(wl, wp, cnt, ts, ti, ps + warp * kMergeN,
                       pi + warp * kMergeN, s, pos, ok, k, lane);
    if (cnt == k) { ts = wl[k - 1]; ti = wp[k - 1]; }
  }
  // positions to ids; each lane reads its slot before it writes it
  for (int i = lane; i < cnt; i += 32) {
    const int p = wp[i];
    out_s[row + i] = wl[i];
    out_i[row + i] = cand_i[static_cast<size_t>(q) * m + p];
  }
}

}  // namespace

extern "C" {

// terms/impacts [N, L]; q_terms/q_weights [Q, T]; cand_* [Q, ceil(N/1024),
// min(k, 1024)] scratch; out_* [Q, k]. Needs T >= 1 (a row's slots are read
// once per 64 terms) and 1 <= k <= N rounded up to 1024. Returns a
// cudaError_t.
int ell_topk(const int* terms, const float* impacts, const int* q_terms,
             const float* q_weights, int N, int L, int Q, int T, int k,
             float* cand_s, int* cand_i, float* out_s, int* out_i,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (N + kBlockN - 1) / kBlockN;
  if (N <= 0 || Q <= 0 || T <= 0 || k <= 0 ||
      static_cast<long long>(k) > static_cast<long long>(nb) * kBlockN)
    return cudaErrorInvalidValue;
  const int kb = k < kBlockN ? k : kBlockN;
  const size_t q_smem = (sizeof(int) + sizeof(float)) * T;
  const size_t m_base = 8ull * kMergeWarps * kMergeN;
  const int list_in_smem = m_base + 8ull * kMergeWarps * k <= kMaxSmem;
  const size_t m_smem = m_base + (list_in_smem ? 8ull * kMergeWarps * k : 0);
  cudaError_t err = cudaFuncSetAttribute(
      ell_block_topk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(q_smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ell_merge,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(m_smem));
  if (err != cudaSuccess) return err;
  ell_block_topk<<<dim3(nb, Q), kBlockN, q_smem, st>>>(
      terms, impacts, q_terms, q_weights, N, L, T, kb, cand_s, cand_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ell_merge<<<(Q + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, m_smem,
              st>>>(cand_s, cand_i, nb * kb, Q, k, list_in_smem, out_s,
                    out_i);
  return cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
