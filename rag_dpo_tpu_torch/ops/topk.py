"""Dense similarity top-k, and the streaming selector's order.

* `fused_topk` — the port of the JAX package's Pallas `fused_topk` (K4):
  exact top-k of `q·eᵀ (+ penalty)` without writing the [Q, N] scores. On
  CUDA tensors it launches the hand-written kernel in `csrc/fused_topk.cu`,
  on CPU tensors it runs `fused_topk_plain` (a matmul, the penalty and a
  stable sort). Equal scores keep the lowest row first (ROADMAP C-13).
* `cosine_topk_reference` — one matmul + exact top-k.
* `blocked_topk` — the JAX scan over row blocks with a running merge,
  written out as a loop (penalty folding and padding kept exactly).
* `approx_topk` — exact top-k followed by the `k·oversample` cut. On the
  CPU `approx_max_k` is exact with lowest-index ties (ROADMAP C-2), so this
  reproduces the JAX records.

`approx_topk` and `blocked_topk` compute one function, exact top-k with
the lowest row first among ties: on CUDA tensors both go through K4 and
return what their CPU code returns, fill slots included.

Every plain selection is a stable descending sort: `lax.top_k` puts the
lower index first among equal scores, and `torch.topk` promises no order.

`streaming_topk_reference` is the plain twin of the order in which the
reference's streaming selector (`topk.py::streaming_topk_update`, shared
by the ELL kernel) emits equal scores: by (1024-row block, extraction
round, 128-row segment), where a row's round is its rank inside its
segment by (score desc, row asc) — ROADMAP C-1.
"""

from __future__ import annotations

import torch

from . import _kernels

NEG_INF = -1e30
_FUSED_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FUSED_MAX_K = 256          # csrc/fused_topk.cu: kMaxK
_FUSED_TILE_N = 128         # rows per tile; a block's rows are a multiple


def _sort_desc(x):
    """Stable descending sort along dim 1 (lower index first among ties).
    Adding 0.0 folds −0.0 into +0.0 so no sort can split equal zeros."""
    return torch.sort(x + 0.0, dim=1, descending=True, stable=True)


def _scores(queries, embs):
    return queries.float() @ embs.float().T


def cosine_topk_reference(queries, embs, k: int):
    """[Q, D], [N, D] → ([Q, k] scores, [Q, k] int32 ids). Full materialize."""
    top, ids = _sort_desc(_scores(queries, embs))
    return top[:, :k], ids[:, :k].to(torch.int32)


def _full_penalty(penalty, n: int, dev):
    """`penalty` as [n] f32: rows past its end get −5e29, as in
    `blocked_topk`."""
    pen = torch.full((n,), NEG_INF / 2, dtype=torch.float32, device=dev)
    m = min(n, penalty.shape[0])
    pen[:m] = penalty[:m].float()
    return pen


def fused_topk_plain(queries, embs, k: int, *, penalty=None):
    """Plain twin of K4: a matmul, the penalty and a stable descending
    sort. Returns ([Q, k] f32, [Q, k] int32), (−1e30, −1) past N."""
    if embs.is_cuda:
        _kernels.PLAIN_ON_CUDA["fused_topk"] += 1
    n = embs.shape[0]
    s = _scores(queries, embs)
    if penalty is not None:
        s = s + _full_penalty(penalty, n, embs.device)[None, :]
    kk = min(k, n)
    vals, idxs = _sort_desc(s)
    vals, idxs = vals[:, :kk], idxs[:, :kk].to(torch.int32)
    if kk < k:
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=NEG_INF)
        idxs = torch.nn.functional.pad(idxs, (0, k - kk), value=-1)
    return vals, idxs


def _fused_topk_kernel(queries, embs, k: int, penalty):
    if queries.dim() != 2 or embs.dim() != 2:
        raise ValueError("fused_topk takes queries [Q, D] and embs [N, D]")
    (q, d), (n, dd) = queries.shape, embs.shape
    if dd != d:
        raise ValueError(f"queries have D={d}, embs D={dd}")
    if not (8 <= d <= 1024 and d % 8 == 0):
        raise ValueError(f"the CUDA fused_topk kernel takes D a multiple of "
                         f"8 from 8 to 1024, got {d}")
    if not 1 <= k <= _FUSED_MAX_K:
        raise ValueError(f"the CUDA fused_topk kernel takes 1 ≤ k ≤ "
                         f"{_FUSED_MAX_K}, got {k}")
    if q < 1 or n < 1:
        raise ValueError(f"fused_topk takes no empty axis, got Q={q} N={n}")
    if embs.dtype not in _FUSED_DTYPES or queries.dtype != embs.dtype:
        raise ValueError(f"the CUDA fused_topk kernel takes f32 or bf16 "
                         f"queries and embs of one dtype, got "
                         f"{queries.dtype} and {embs.dtype}")
    dev = embs.device
    for name, x in (("queries", queries), ("penalty", penalty)):
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, embs on {dev}")
    for name, x in (("queries", queries), ("embs", embs)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if penalty is not None:
        if penalty.dim() != 1:
            raise ValueError("penalty must be [N]")
        penalty = penalty.float().contiguous()
    # blocks of whole 128-row tiles, about four per SM over all query tiles
    tq = 16 if q <= 16 else 64
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunks = max(1, -(-4 * sms // -(-q // tq)))
    rows = max(_FUSED_TILE_N, -(-n // chunks))
    rows = -(-rows // _FUSED_TILE_N) * _FUSED_TILE_N
    n_chunks = -(-n // rows)
    cand_s = torch.empty((q, n_chunks, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((q, n_chunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    lib = _kernels.load("fused_topk")
    with torch.cuda.device(dev):
        err = lib.fused_topk(
            _FUSED_DTYPES[embs.dtype], _kernels.ptr(queries),
            _kernels.ptr(embs), _kernels.ptr(penalty),
            0 if penalty is None else penalty.shape[0], q, n, d, k, rows,
            _kernels.ptr(cand_s), _kernels.ptr(cand_i), _kernels.ptr(out_s),
            _kernels.ptr(out_i), _kernels.stream_of(embs))
    _kernels.check(lib, err, "fused_topk")
    _kernels.LAUNCHES["fused_topk"] += 1
    return out_s, out_i


def fused_topk(queries, embs, k: int, *, penalty=None):
    """Exact top-k of `queries · embsᵀ (+ penalty)`: ([Q, k] f32 scores,
    [Q, k] int32 rows), the lowest row first among equal scores; rows past
    `penalty`'s end count −5e29 and slots past N are (−1e30, −1).

    On CUDA: queries and embs both f32 or both bf16, contiguous, D a
    multiple of 8 up to 1024, 1 ≤ k ≤ 256; anything else raises."""
    if embs.is_cuda:
        return _fused_topk_kernel(queries, embs, k, penalty)
    return fused_topk_plain(queries, embs, k, penalty=penalty)


def blocked_topk(queries, embs, k: int, block_n: int = 4096, penalty=None):
    """Memory-bounded exact top-k: loop over row blocks with a running
    merge. `penalty` [N] (0 keep / large-negative exclude) folds tombstone
    and filter masks in; rows past `penalty` get −5e29, rows past N −1e30.

    On CUDA it is K4 (`block_n` plays no part there); the running merge's
    fill slots, (−1e30, 0) when k > N, are kept."""
    if embs.is_cuda:
        s, i = fused_topk(queries, embs, k, penalty=penalty)
        return s, torch.where(i < 0, 0, i)
    n, d = embs.shape
    q = queries.shape[0]
    dev = embs.device
    nb = -(-n // block_n)
    qf = queries.float()
    run_s = torch.full((q, k), NEG_INF, dtype=torch.float32, device=dev)
    run_i = torch.zeros((q, k), dtype=torch.int32, device=dev)
    for j in range(nb):
        base = j * block_n
        s = qf @ embs[base:base + block_n].float().T
        width = s.shape[1]
        if width < block_n:  # the reference zero-pads the last block
            s = torch.cat([s, torch.zeros((q, block_n - width), device=dev)],
                          dim=1)
        if penalty is None:
            pblk = torch.zeros((block_n,), dtype=torch.float32, device=dev)
        else:
            pblk = torch.full((block_n,), NEG_INF / 2, dtype=torch.float32,
                              device=dev)
            got = penalty[base:base + block_n].float()
            pblk[: got.shape[0]] = got
        s = s + pblk[None, :]
        valid = base + torch.arange(block_n, device=dev) < n
        s = torch.where(valid[None, :], s, NEG_INF)
        bs, bi = _sort_desc(s)
        kb = min(k, block_n)
        bs, bi = bs[:, :kb], (bi[:, :kb] + base).to(torch.int32)
        ms, mp = _sort_desc(torch.cat([run_s, bs], dim=1))
        run_i = torch.gather(torch.cat([run_i, bi], dim=1), 1, mp[:, :k])
        run_s = ms[:, :k]
    return run_s, run_i


def approx_topk(queries, embs, k: int, oversample: int = 4, penalty=None):
    """matmul + exact stable top-`k·oversample`, cut to k; pads with
    (−1e30, −1) when the corpus holds fewer than k rows. On CUDA it is K4,
    which computes the same function."""
    if embs.is_cuda:
        return fused_topk(queries, embs, k, penalty=penalty)
    scores = _scores(queries, embs)
    if penalty is not None:
        scores = scores + penalty.float()[None, :]
    kk = min(k * oversample, scores.shape[1])
    vals, idxs = _sort_desc(scores)
    vals, idxs = vals[:, :min(k, kk)], idxs[:, :min(k, kk)]
    if kk < k:
        pad = k - kk
        vals = torch.nn.functional.pad(vals, (0, pad), value=NEG_INF)
        idxs = torch.nn.functional.pad(idxs, (0, pad), value=-1)
    return vals, idxs.to(torch.int32)


def streaming_topk_reference(scores, k: int, *, block_n: int = 1024,
                             seg: int = 128, n_valid: int | None = None):
    """Exact top-k of [Q, N] scores in the reference streaming order.

    Columns at or past `n_valid` (default N) are empty: score −1e30, id −1.
    Returns ([Q, k] f32 scores, [Q, k] int32 ids); needs k ≤ N rounded up
    to `block_n`."""
    q, n = scores.shape
    dev = scores.device
    n_valid = n if n_valid is None else n_valid
    seg = min(seg, block_n)
    assert block_n % seg == 0, (block_n, seg)
    n_pad = -(-n // block_n) * block_n
    col = torch.arange(n_pad, device=dev)
    s = torch.full((q, n_pad), NEG_INF, dtype=torch.float32, device=dev)
    s[:, :n] = scores.float()
    s = torch.where(col[None, :] < n_valid, s, NEG_INF)
    # round = rank inside the segment by (score desc, row asc)
    order = _sort_desc(s.reshape(q * (n_pad // seg), seg)).indices
    rnd = torch.empty_like(order)
    rnd.scatter_(1, order, torch.arange(seg, device=dev).expand_as(order))
    rnd = rnd.reshape(q, n_pad)
    nseg = block_n // seg
    tie_key = ((col // block_n) * block_n + rnd * nseg
               + (col % block_n) // seg)  # unique per row
    perm = torch.argsort(tie_key, dim=1)
    top, pos = _sort_desc(torch.gather(s, 1, perm))
    top, pos = top[:, :k], pos[:, :k]
    ids = torch.gather(perm, 1, pos)
    ids = torch.where(top > NEG_INF / 2, ids, -1)
    return top, ids.to(torch.int32)
