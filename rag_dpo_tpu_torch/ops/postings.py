"""Impact-ordered inverted index: the sparse engine at corpus scale.

Port of `rag_dpo_tpu/ops/postings.py`, plain torch as the reference is
XLA. Postings are dense per term: a [V, cap] doc-id table (SENTINEL
padded) and a [V, cap] impact table, each term's row sorted by descending
impact and cut at `cap`. A query gathers its terms' rows, keeps the
`n_candidates` best single contributions (a stable descending sort, lowest
position first among equal contributions, as the CPU `approx_max_k`),
re-scores each candidate's whole ELL row exactly, drops repeated ids
(first occurrence wins) and takes the exact top-k.

`PostingsIndex.build` inverts in C++ (`native.invert_postings_native`)
where the JAX build does, when the library is available, else on the
reference's numpy path; unlike JAX's, it lets an error of a library that
did load reach the caller (ROADMAP C-25).
The re-score adds a candidate's contributions in float64 and rounds once,
so every device gives the same bits whatever order its reduction takes;
XLA's f32 sum (`postings.py:141`) rounds after each add in an order of its
own and can differ in the last bits (ROADMAP C-15).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .topk import NEG_INF, _sort_desc

SENTINEL = np.int32(0x7FFFFFFF)


@dataclasses.dataclass
class PostingsIndex:
    """Host container for the dense per-term posting tables."""

    post_docs: np.ndarray     # [V, cap] int32 doc ids, SENTINEL padded
    post_impacts: np.ndarray  # [V, cap] f32, impact-desc within a row
    cap: int
    n_docs: int

    @classmethod
    def build(cls, terms: np.ndarray, impacts: np.ndarray,
              vocab_size: int, cap: int = 512) -> "PostingsIndex":
        """Invert ELL arrays ([N, L] term ids / impacts) into the dense
        capped, impact-ordered layout. Uses the C++ ingestion runtime
        when available (≈4× faster than the numpy lexsort path at 1M)."""
        from .. import native

        n, l = terms.shape
        if native.is_available():
            post_docs, post_impacts = native.invert_postings_native(
                terms, impacts, vocab_size, cap)
            return cls(post_docs=post_docs, post_impacts=post_impacts,
                       cap=cap, n_docs=n)
        flat_terms = terms.reshape(-1)
        flat_imps = impacts.reshape(-1)
        flat_docs = np.repeat(np.arange(n, dtype=np.int32), l)
        valid = flat_terms >= 0
        flat_terms = flat_terms[valid]
        flat_imps = flat_imps[valid]
        flat_docs = flat_docs[valid]

        # sort by (term asc, impact desc); rank within term
        order = np.lexsort((-flat_imps, flat_terms))
        t_sorted = flat_terms[order]
        d_sorted = flat_docs[order]
        i_sorted = flat_imps[order]
        counts = np.bincount(t_sorted, minlength=vocab_size)
        starts = np.zeros(vocab_size + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        rank = np.arange(len(t_sorted)) - starts[t_sorted]
        keep = rank < cap

        post_docs = np.full((vocab_size, cap), SENTINEL, np.int32)
        post_impacts = np.zeros((vocab_size, cap), np.float32)
        post_docs[t_sorted[keep], rank[keep]] = d_sorted[keep]
        post_impacts[t_sorted[keep], rank[keep]] = i_sorted[keep]
        return cls(post_docs=post_docs, post_impacts=post_impacts,
                   cap=cap, n_docs=n)

    def device_arrays(self, device):
        return (torch.from_numpy(self.post_docs).to(device),
                torch.from_numpy(self.post_impacts).to(device))


def postings_candidates_topk(post_docs, post_impacts, ell_terms, ell_impacts,
                             q_terms, q_weights, k: int,
                             n_candidates: int = 256, penalty=None):
    """Two-phase sparse top-k.

    post_docs/post_impacts: [V, cap]; ell_terms/ell_impacts: [N, L];
    q_terms [Q, T] int32 (−2 = empty), q_weights [Q, T] f32 →
    ([Q, k] f32 scores, [Q, k] int32 doc ids, −1 padded). Scores are exact
    BM25 totals of every returned doc; `penalty` [N] (0 keep,
    large-negative exclude) is added to each candidate's total."""
    q, t = q_terms.shape
    cap = post_docs.shape[1]
    sentinel = int(SENTINEL)
    q_terms = q_terms.long()
    q_weights = q_weights.float()
    tid = q_terms.clamp(0, post_docs.shape[0] - 1)
    q_valid = (q_terms >= 0)[:, :, None]

    docs = torch.where(q_valid, post_docs[tid], sentinel)        # [Q, T, cap]
    scores = torch.where(q_valid & (docs != sentinel),
                         post_impacts[tid] * q_weights[:, :, None], 0.0)
    docs = docs.reshape(q, t * cap)
    scores = scores.reshape(q, t * cap)

    c = min(n_candidates, docs.shape[1])
    pos = _sort_desc(scores).indices[:, :c]
    cand = torch.gather(docs, 1, pos)                            # [Q, C]
    cand_valid = cand != sentinel
    safe = torch.where(cand_valid, cand, 0).long()

    ct = ell_terms[safe]                                         # [Q, C, L]
    ci = ell_impacts[safe].float()
    match = ct[:, :, :, None] == q_terms[:, None, None, :]       # [Q,C,L,T]
    contrib = torch.where(match, ci[:, :, :, None]
                          * q_weights[:, None, None, :], 0.0)
    total = contrib.double().sum(dim=(2, 3)).float()              # [Q, C]
    if penalty is not None:
        total = total + penalty.float()[safe]

    # first-occurrence dedup on the raw ids (SENTINEL intact, so empty slots
    # never mark doc 0 a repeat)
    same = cand[:, :, None] == cand[:, None, :]
    earlier = torch.triu(torch.ones((c, c), dtype=torch.bool,
                                    device=cand.device), diagonal=1)
    dup = (same & earlier[None]).any(dim=1)
    total = torch.where(cand_valid & ~dup, total, NEG_INF)

    kk = min(k, c)
    top, ppos = _sort_desc(total)
    top, ppos = top[:, :kk], ppos[:, :kk]
    top_docs = torch.gather(safe, 1, ppos)
    top_docs = torch.where(top > NEG_INF / 2, top_docs, -1).to(torch.int32)
    if kk < k:
        top = torch.nn.functional.pad(top, (0, k - kk), value=NEG_INF)
        top_docs = torch.nn.functional.pad(top_docs, (0, k - kk), value=-1)
    return top, top_docs
