"""Sparse lexical (BM25 / learned-impact) scoring over an ELL corpus.

    doc_terms   [N, L] int32  — per-chunk term ids, −1 padded
    doc_impacts [N, L] f32    — precomputed per-term BM25 impact
    q_terms     [Q, T] int32  — query term ids, −2 padded
    q_weights   [Q, T] f32    — per-term weights (IDF)

`ell_topk` is the port of the JAX package's Pallas `ell_topk`: on CUDA
tensors it launches the hand-written kernel in `csrc/ell_topk.cu`, on CPU
tensors it runs `ell_topk_plain`. Both return the reference's exact top-k,
including its order among equal scores (`topk.streaming_topk_reference`);
zero-score rows stay ranked and fill the remaining slots. The kernel ranks
rows by one unique 64-bit key each, whose host mirror is `ell_order_keys`.

`ell_scores` (full [Q, N] scores, for the masked search path) is plain
torch, as in the JAX package, where it is an XLA scan.
"""

from __future__ import annotations

import contextlib

import torch

from . import _kernels
from .topk import NEG_INF, streaming_topk_reference


def ell_scores_reference(doc_terms, doc_impacts, q_terms, q_weights):
    """Oracle: [N, L], [N, L], [Q, T], [Q, T] → [Q, N] f32 scores."""
    match = doc_terms[None, :, :, None] == q_terms[:, None, None, :]
    contrib = (match * doc_impacts[None, :, :, None]
               * q_weights[:, None, None, :])
    return contrib.sum(dim=(2, 3))


def _fma(a, b, c):
    """f32 a·b + c with one rounding: the product of two f32 values is
    exact in f64, so only the (practically never tied) f64 sum rounds
    twice."""
    return (a.double() * b.double() + c.double()).float()


def ell_scores(doc_terms, doc_impacts, q_terms, q_weights):
    """Full [Q, N] lexical scores, summed term by term in t order like the
    reference's `_ell_score_block`, with the fused multiply-adds XLA's CPU
    compiler puts into that sum: fma(w0, h0, w1·h1), then fma(wt, ht, acc).
    Matching them makes the scores, and so the tie order, bit-exact."""
    imp = doc_impacts.float()
    hits = []
    for t in range(q_terms.shape[1]):
        match = doc_terms[None, :, :] == q_terms[:, t, None, None]  # [Q,N,L]
        # ≤ one slot matches per (row, term), so this sum is exact
        hits.append((q_weights[:, t, None].float(),
                     torch.where(match, imp[None], 0.0).sum(dim=2)))
    (w0, h0), rest = hits[0], hits[1:]
    if not rest:
        return w0 * h0
    (w1, h1), rest = rest[0], rest[1:]
    acc = _fma(w0, h0, w1 * h1)
    for w, h in rest:
        acc = _fma(w, h, acc)
    return acc


def ell_topk_plain(doc_terms, doc_impacts, q_terms, q_weights, k: int,
                   *, block_n: int = 1024):
    """Plain twin of the ELL kernel: full scores, then the reference's
    streaming top-k order. Returns [Q, min(k, N)]."""
    if doc_terms.is_cuda:
        _kernels.count_plain("ell_topk")
    n = doc_terms.shape[0]
    s = ell_scores(doc_terms, doc_impacts, q_terms, q_weights)
    return streaming_topk_reference(s, min(k, n), block_n=block_n, n_valid=n)


def ell_order_keys(scores, *, block_n: int = 1024, seg: int = 128):
    """The ELL kernel's selection key of every row, on the host: [Q, N]
    scores → [Q, N] int64 keys, unique in a query, whose descending order
    is the reference's streaming order (`streaming_topk_reference`).

    The key is the kernel's unsigned 64-bit one with its top bit flipped
    (so that int64 compares as it does): above, the f32 score's bits made
    order-preserving, −0.0 as +0.0 (the reference's compare holds them
    equal); below, the complement of block·block_n + round·(block_n / seg)
    + segment, where a row's round is its rank inside its segment by
    (score desc, row asc). Rows past N count as −1e30, as in the kernel."""
    q, n = scores.shape
    n_pad = -(-n // block_n) * block_n
    s = torch.full((q, n_pad), NEG_INF, dtype=torch.float32,
                   device=scores.device)
    s[:, :n] = scores.float()
    bits = (s + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    # the kernel's order bits, less 2^31: the key's top bit flipped
    order = torch.where(bits >> 31 == 1, bits ^ 0xFFFFFFFF,
                        bits ^ 0x80000000) - (1 << 31)
    col = torch.arange(n_pad, device=scores.device)
    # round: the rank inside the segment by (score desc, row asc)
    seg_key = (order << 32) | ((n_pad - 1) - col)[None, :]
    rank = torch.argsort(torch.argsort(
        seg_key.reshape(q, n_pad // seg, seg), dim=2, descending=True),
        dim=2)
    tie = ((col // block_n) * block_n + rank.reshape(q, n_pad)
           * (block_n // seg) + (col % block_n) // seg)
    return ((order << 32) | (0xFFFFFFFF - tie))[:, :n]


def _ell_inputs(doc_terms, doc_impacts, q_terms, q_weights, k: int,
                block_n: int) -> list:
    """What the ELL kernel refuses (ValueError), or its four inputs as it
    takes them (int32 / f32, contiguous). Any number of query terms runs
    (the kernel matches them 32 at a time, its sum still in t order), and
    any k up to N: blocks keep min(k, 1024) rows each and a second pass
    merges them by rank."""
    n, l = doc_terms.shape
    q, t = q_terms.shape
    if block_n != 1024:
        raise ValueError("the CUDA ELL kernel streams 1024-row blocks")
    if not 1 <= k <= n:
        raise ValueError(f"the CUDA ELL kernel takes 1 ≤ k ≤ N, got {k}")
    if t < 1:
        raise ValueError("the CUDA ELL kernel takes at least one query term")
    if doc_impacts.shape != (n, l) or q_weights.shape != (q, t):
        raise ValueError("impacts must match terms, and weights q_terms, "
                         "in shape")
    dev = doc_terms.device
    args = []
    for x, dtype in ((doc_terms, torch.int32), (doc_impacts, torch.float32),
                     (q_terms, torch.int32), (q_weights, torch.float32)):
        if x.device != dev:
            raise ValueError("ELL inputs must share one device")
        # checked, not converted, where they already fit: a search's host
        # time counts at these sizes (evals/probe_ell.py, `host_us`)
        if x.dtype != dtype or not x.is_contiguous():
            x = x.to(dtype).contiguous()
        args.append(x)
    return args


def _ell_topk_kernel(doc_terms, doc_impacts, q_terms, q_weights, k: int,
                     block_n: int):
    args = _ell_inputs(doc_terms, doc_impacts, q_terms, q_weights, k,
                       block_n)
    (n, l), (q, t) = doc_terms.shape, q_terms.shape
    dev = doc_terms.device
    nb = -(-n // block_n)
    # one block needs no second pass, and no scratch
    scratch = (torch.empty(12 * q * nb * min(k, block_n), dtype=torch.uint8,
                           device=dev) if nb > 1 else None)
    out_s = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    lib = _kernels.load("ell_topk")
    # the device is switched only where it is not the current one
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        err = lib.ell_topk(
            *(x.data_ptr() for x in args), n, l, q, t, k,
            _kernels.ptr(scratch), out_s.data_ptr(), out_i.data_ptr(),
            _kernels.stream_of(doc_terms))
    _kernels.check(lib, err, "ell_topk")
    _kernels.count_launch("ell_topk")
    return out_s, out_i


def ell_topk(doc_terms, doc_impacts, q_terms, q_weights, k: int,
             *, block_n: int = 1024):
    """Top-k lexical retrieval: ([Q, k] f32 scores, [Q, k] int32 ids).

    Zero-score documents are still ranked (BM25 semantics allow ties at 0);
    slots beyond the corpus are id −1 / score −1e30."""
    n = doc_terms.shape[0]
    k_eff = min(k, n)
    if doc_terms.is_cuda:
        out_s, out_i = _ell_topk_kernel(doc_terms, doc_impacts, q_terms,
                                        q_weights, k_eff, block_n)
    else:
        out_s, out_i = ell_topk_plain(doc_terms, doc_impacts, q_terms,
                                      q_weights, k_eff, block_n=block_n)
    if k_eff < k:
        pad = k - k_eff
        out_s = torch.nn.functional.pad(out_s, (0, pad), value=NEG_INF)
        out_i = torch.nn.functional.pad(out_i, (0, pad), value=-1)
    return out_s, out_i
