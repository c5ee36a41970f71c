"""Weighted Reciprocal Rank Fusion.

Each arm contributes ``weight / (k + rank)`` (rank from 1, k = 60);
contributions for the same id sum across arms. Same fixed-shape program as
the JAX package (`rag_dpo_tpu/ops/fusion.py`): a pairwise equality matmul
over the concatenated candidate list, first-occurrence dedup, then a
stable descending sort, so among equal fused scores the id that occurs
first in the (arm, rank) list wins, as with `lax.top_k`. Expansion arms
share weight 1.0, so exact ties are common. Invalid slots are id −1.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def rrf_fuse_reference(rankings, weights, k_rrf: int = 60):
    """Host oracle: rankings = list of lists of ids (ordered best-first).

    Returns {id: fused_score}.
    """
    scores: dict[int, float] = {}
    for ranking, w in zip(rankings, weights):
        for rank, cid in enumerate(ranking, start=1):
            if cid < 0:
                continue
            scores[cid] = scores.get(cid, 0.0) + w / (k_rrf + rank)
    return scores


def rrf_fuse(ids, weights, *, k_rrf: int = 60, topk: int):
    """Fuse ranked id lists.

    ids:     [A, Q, L] int — per-arm ranked ids, best first, −1 = empty.
    weights: [A] float32 — per-arm RRF weight.
    Returns ([Q, topk] fused scores, [Q, topk] int32 ids); empty slots are
    id −1 with score −1e30.
    """
    a, q, l = ids.shape
    dev = ids.device
    rank = torch.arange(1, l + 1, dtype=torch.float32, device=dev)
    contrib = weights.float()[:, None] / (k_rrf + rank)[None, :]  # [A, L]
    contrib = contrib[:, None, :].expand(a, q, l)

    flat_ids = ids.transpose(0, 1).reshape(q, a * l)
    flat_contrib = contrib.transpose(0, 1).reshape(q, a * l)
    valid = flat_ids >= 0
    flat_contrib = torch.where(valid, flat_contrib, 0.0)

    same = flat_ids[:, :, None] == flat_ids[:, None, :]  # [Q, M, M]
    same = same & valid[:, :, None] & valid[:, None, :]
    fused = torch.einsum("qij,qj->qi", same.float(), flat_contrib)

    m = flat_ids.shape[1]
    earlier = torch.tril(torch.ones((m, m), dtype=torch.bool, device=dev),
                         diagonal=-1)  # j < i
    dup = (same & earlier[None]).any(dim=2)
    score = torch.where(valid & ~dup, fused, NEG_INF)

    kk = min(topk, m)
    top, pos = torch.sort(score, dim=1, descending=True, stable=True)
    top, pos = top[:, :kk], pos[:, :kk]
    top_ids = torch.gather(flat_ids, 1, pos)
    top_ids = torch.where(top > NEG_INF / 2, top_ids, -1).to(torch.int32)
    if kk < topk:
        pad = topk - kk
        top = torch.nn.functional.pad(top, (0, pad), value=NEG_INF)
        top_ids = torch.nn.functional.pad(top_ids, (0, pad), value=-1)
    return top, top_ids
