"""Int8 index quantization and the int8 × int8 searches over it.

    x_i8 = clip(round(x / s), −127, 127),  s = max(max|x|, 1e-12) / 127
    score(q, d) = (q_i8 · d_i8) · s_q · s_d

Port of `rag_dpo_tpu/ops/quantize.py`, plain torch on the device of the
inputs: the JAX package computes none of it in a Pallas kernel.
`quantize_rows` is bit for bit (IEEE f32 division; `torch.round` rounds half
to even, as `jnp.round` does). The int8 × int8 → int32 product is XLA's dot
there and `_int8_product` here (`torch._int_mm`), exact on both. The scores
are formed in XLA's order (× s_q, then × s_d, then + penalty, then to bf16
where the reference casts). Selection is exact, as the reference's is on
the CPU, with the lowest index first among equal scores (`_stable_topk`,
the head of a stable descending sort). That is `lax.top_k`'s order there;
`lax.approx_max_k` of the bf16 scores keeps its unstable sort's order among
equal values (ROADMAP C-2), so the two agree up to which of several equal
scores a cut keeps.

* `approx_topk_int8`: the sweep and an exact top-k of its f32 scores;
* `approx_topk_int8_refined`: the sweep in bf16, the best k·oversample
  re-scored against a full-precision row store `e_ref`;
* `approx_topk_int8_selfrefined`: the same, re-scored against the
  dequantized int8 rows (no row store needed);
* `int8_blockscan_candidates` / `approx_topk_int8_blockscan`: the sweep
  scanned over row blocks with a running top-(k·oversample) merge, so the
  live [Q, block] intermediate bounds the batch, not [Q, N];
* `dequant_refine`: an exact re-score of given candidates against the
  dequantized rows.

The store's default int8 arm runs `approx_topk_int8` (then its host refine),
and `device_refine` the self-refined and block-scanned searches
(`index/store.py`), as the reference's store does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .topk import pad_columns

NEG = -1e30


def quantize_rows(x):
    """[N, D] float (tensor or array) → ([N, D] int8, [N] f32 scales), on
    the tensor's device, the same bits on the CPU and on CUDA.

    The divisor 127 is a tensor on the rows' device: CUDA divides by a
    Python scalar as a multiply by its reciprocal, which is not correctly
    rounded, and a scale one ulp off can move x / scale across a rounding
    boundary."""
    x = torch.as_tensor(x).float()
    amax = x.abs().amax(dim=1, keepdim=True)
    scale = amax.clamp_min(1e-12) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def _int8_product(q_i8, e_i8):
    """[Q, D] int8 × [N, D] int8 → [Q, N] int32, exact (XLA's int8 dot with
    `preferred_element_type=int32`).

    On the CPU the product runs in f64, which holds every such sum exactly
    (a CPU int8 GEMM may sum pairs of products in saturating 16 bits). On
    CUDA, `torch._int_mm` (cuBLASLt's int8 product, int32 sums on the tensor
    cores) takes more than 16 rows in its first operand and D and N in
    multiples of 8: the queries get zero rows, dropped after; a D off the
    multiple gets zero columns (a copy); the last N mod 8 rows go through a
    second call on an 8-row copy."""
    if not q_i8.is_cuda:
        return (q_i8.double() @ e_i8.double().T).to(torch.int32)
    q, n = q_i8.shape[0], e_i8.shape[0]
    q_i8, e_i8 = pad_columns(q_i8, 8), pad_columns(e_i8, 8)
    if q <= 16:
        q_i8 = F.pad(q_i8, (0, 0, 0, 17 - q))
    n8 = n - n % 8
    parts = []
    if n8:
        parts.append(torch._int_mm(q_i8, e_i8[:n8].T))
    if n8 < n:
        tail = F.pad(e_i8[n8:], (0, 0, 0, 8 - (n - n8)))
        parts.append(torch._int_mm(q_i8, tail.T)[:, : n - n8])
    raw = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return raw[:q]


def _sweep(q_i8, q_scale, e_i8, e_scale, penalty=None):
    """[Q, N] f32 scores: the int32 product × s_q × s_d (+ penalty), in the
    reference's order."""
    s = _int8_product(q_i8, e_i8).float()
    s = s * q_scale[:, None] * e_scale[None, :]
    if penalty is not None:
        s = s + penalty[None, :]
    return s


def _stable_topk(x, k: int):
    """The first k of a stable descending sort of x along dim 1 (the lowest
    index first among equal values, −0.0 equal to +0.0): (values as f32,
    int64 positions).

    `torch.topk` promises no order among ties, so it runs on unique int64
    keys: the f32 value's bits made order-preserving (negative values with
    their magnitude bits flipped) above the position's complement. The
    largest k keys are then exactly the sort's first k, in its order."""
    n = x.shape[1]
    key = (x.float() + 0.0).view(torch.int32).to(torch.int64)
    key ^= (key >> 63) & 0x7FFFFFFF
    key <<= 32
    key |= (n - 1) - torch.arange(n, device=x.device)[None, :]
    pos = (n - 1) - (torch.topk(key, k, dim=1).values & 0xFFFFFFFF)
    return torch.gather(x.float(), 1, pos), pos


def _dequant_rows(e_i8, e_scale, ids):
    """[Q, C, D] f32: the int8 rows at `ids` times their scales."""
    return e_i8[ids].float() * e_scale[ids][:, :, None]


def _rescore(q_f32, rows):
    """[Q, C] exact f32 scores of each query against its candidate rows."""
    return torch.einsum("qd,qcd->qc", q_f32.float(), rows)


def _pad_k(top, ids, k: int):
    """(−1e30, −1) past the kk < k columns that exist."""
    kk = top.shape[1]
    if kk < k:
        top = F.pad(top, (0, k - kk), value=NEG)
        ids = F.pad(ids, (0, k - kk), value=-1)
    return top, ids.to(torch.int32)


def _top_refined(exact, cids, k: int, *, drop_empty: bool):
    """Exact top-min(k, C) of the re-scored candidates → their ids; with
    `drop_empty`, a slot scored −1e30 carries id −1."""
    top, pos = _stable_topk(exact, min(k, exact.shape[1]))
    ids = torch.gather(cids, 1, pos)
    if drop_empty:
        ids = torch.where(top > -1e29, ids, -1)
    return _pad_k(top, ids, k)


def approx_topk_int8_refined(q_f32, e_i8, e_scale, e_ref, k: int,
                             oversample: int = 4, penalty=None,
                             recall_target: float = 0.95):
    """Int8 sweep (scores to bf16) → the best k·oversample → exact f32
    re-score against `e_ref` (any float row store; its dtype sets the
    refine's precision) → exact top-k: ([Q, k] f32, [Q, k] int32), (−1e30,
    −1) padded. Candidates whose bf16 score carries the −1e4 penalty
    (≤ −1e3) score −1e30. `recall_target` is the reference's argument to
    the TPU's approximate selection; the selection here is exact, as the
    reference's is on the CPU."""
    del recall_target
    q_i8, q_scale = quantize_rows(q_f32)
    scores = _sweep(q_i8, q_scale, e_i8, e_scale, penalty).to(torch.bfloat16)
    kk = min(k * oversample, scores.shape[1])
    cvals, cids = _stable_topk(scores, kk)
    exact = _rescore(q_f32, e_ref[cids].float())
    exact = torch.where(cvals > -1e3, exact, NEG)
    return _top_refined(exact, cids, k, drop_empty=False)


def dequant_refine(q_f32, e_i8, e_scale, cand_scores, cand_ids, k: int):
    """Exact re-score of candidate ids against the dequantized int8 rows.
    `cand_scores` carry the sweep's penalties: slots at or below −5e3, and
    ids −1, stay excluded (−1e30, −1)."""
    safe = torch.where(cand_ids >= 0, cand_ids, 0).long()
    exact = _rescore(q_f32, _dequant_rows(e_i8, e_scale, safe))
    exact = torch.where((cand_ids >= 0) & (cand_scores > -5e3), exact, NEG)
    return _top_refined(exact, safe, k, drop_empty=True)


def approx_topk_int8_selfrefined(q_f32, e_i8, e_scale, k: int,
                                 oversample: int = 4, penalty=None):
    """Int8 sweep (scores to bf16) → the best k·oversample → exact f32
    re-score against the dequantized int8 rows → exact top-k. No
    full-precision row store is needed; scores are exact under the
    quantized corpus q·(d_i8·s_d). ([Q, k] f32, [Q, k] int32), (−1e30, −1)
    for empty or penalized slots."""
    q_i8, q_scale = quantize_rows(q_f32)
    scores = _sweep(q_i8, q_scale, e_i8, e_scale, penalty).to(torch.bfloat16)
    kk = min(k * oversample, scores.shape[1])
    cvals, cids = _stable_topk(scores, kk)
    exact = _rescore(q_f32, _dequant_rows(e_i8, e_scale, cids))
    exact = torch.where(cvals > -1e3, exact, NEG)
    return _top_refined(exact, cids, k, drop_empty=True)


def int8_blockscan_candidates(q_i8, q_scale, e_i8, e_scale, kk: int,
                              block_rows: int, penalty=None):
    """The int8 sweep scanned over `block_rows`-row blocks → (candidate
    scores [Q, kk] f32, row ids [Q, kk] int32), a running top-kk merge of
    each block's bf16 top-kk. The last block starts at N − block_rows
    (clamped, as `lax.dynamic_slice` clamps); its rows already scored by the
    block before score −inf, so no id appears twice. Slots never filled
    stay (−inf, −1)."""
    n = e_i8.shape[0]
    q = q_i8.shape[0]
    dev = e_i8.device
    block_rows = min(block_rows, n)
    n_blocks = -(-n // block_rows)
    kk = min(kk, n)
    cvals = torch.full((q, kk), -torch.inf, device=dev)
    cids = torch.full((q, kk), -1, dtype=torch.int32, device=dev)
    for j in range(n_blocks):
        start = min(j * block_rows, n - block_rows)
        rows = slice(start, start + block_rows)
        pen = None if penalty is None else penalty[rows]
        scores = _sweep(q_i8, q_scale, e_i8[rows], e_scale[rows], pen)
        rows_global = start + torch.arange(block_rows, dtype=torch.int32,
                                           device=dev)
        scores = torch.where(rows_global[None, :] >= j * block_rows, scores,
                             -torch.inf).to(torch.bfloat16)
        bvals, bidx = _stable_topk(scores, min(kk, block_rows))
        mvals = torch.cat([cvals, bvals], dim=1)
        mids = torch.cat([cids, rows_global[bidx]], dim=1)
        cvals, pos = _stable_topk(mvals, kk)
        cids = torch.gather(mids, 1, pos)
    return cvals, cids


def approx_topk_int8_blockscan(q_f32, e_i8, e_scale, k: int,
                               oversample: int = 4,
                               block_rows: int = 1_048_576,
                               penalty=None, e_ref=None):
    """`int8_blockscan_candidates` with k·oversample candidates, then the
    exact re-score against the dequantized int8 rows (or against `e_ref`
    where given, as `approx_topk_int8_refined` does) → exact top-k:
    ([Q, k] f32, [Q, k] int32), (−1e30, −1) for empty or penalized
    slots."""
    q_i8, q_scale = quantize_rows(q_f32)
    kk = min(k * oversample, e_i8.shape[0])
    cvals, cids = int8_blockscan_candidates(
        q_i8, q_scale, e_i8, e_scale, kk, block_rows, penalty=penalty)
    safe = torch.where(cids >= 0, cids, 0).long()
    rows = (_dequant_rows(e_i8, e_scale, safe) if e_ref is None
            else e_ref[safe].float())
    exact = _rescore(q_f32, rows)
    exact = torch.where((cids >= 0) & (cvals > -1e3), exact, NEG)
    return _top_refined(exact, safe, k, drop_empty=True)


def approx_topk_int8(q_i8, q_scale, e_i8, e_scale, k: int,
                     oversample: int = 4, penalty=None):
    """Int8 dense search without a refine: the f32 sweep scores' exact
    top-k ([Q, k] f32, [Q, k] int32), (−1e30, −1) padded past N (the
    reference's `approx_max_k` of k·oversample, then `top_k` of k)."""
    scores = _sweep(q_i8, q_scale, e_i8, e_scale, penalty)
    vals, idxs = _stable_topk(scores, min(k * oversample, scores.shape[1],
                                          k))
    return _pad_k(vals, idxs, k)
