"""Dense similarity top-k in plain torch, and the streaming selector's order.

The JAX package's dense arm is an XLA matmul + `approx_max_k`; it has no
Pallas kernel on the main path, so the port keeps it plain:

* `cosine_topk_reference` — one matmul + exact top-k.
* `blocked_topk` — the JAX scan over row blocks with a running merge,
  written out as a loop (penalty folding and padding kept exactly).
* `approx_topk` — exact top-k followed by the `k·oversample` cut. On the
  CPU `approx_max_k` is exact with lowest-index ties (ROADMAP C-2), so this
  reproduces the JAX records.

Every selection is a stable descending sort: `lax.top_k` puts the lower
index first among equal scores, and `torch.topk` promises no order.

`streaming_topk_reference` is the plain twin of the order in which the
reference's streaming selector (`topk.py::streaming_topk_update`, shared
by the ELL kernel) emits equal scores: by (1024-row block, extraction
round, 128-row segment), where a row's round is its rank inside its
segment by (score desc, row asc) — ROADMAP C-1.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


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


def blocked_topk(queries, embs, k: int, block_n: int = 4096, penalty=None):
    """Memory-bounded exact top-k: loop over row blocks with a running
    merge. `penalty` [N] (0 keep / large-negative exclude) folds tombstone
    and filter masks in; rows past `penalty` get −5e29, rows past N −1e30."""
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
    (−1e30, −1) when the corpus holds fewer than k rows."""
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
