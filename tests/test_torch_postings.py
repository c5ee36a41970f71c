"""The postings engine of the port against the JAX package, on the CPU.

`PostingsIndex.build` is the reference's numpy path (the C++ inversion is
pinned off on both sides, as for the BM25 impacts, ROADMAP C-8;
`tests/test_torch_native.py` holds the port's to it).
`postings_candidates_topk` must return the same ids and scores. The port
adds each candidate's contributions in float64 and rounds once (the same
bits on every device); XLA adds them in f32 in an order that depends on
the shapes (its CPU compiler splits reductions over more than 32 slots
and vectorises the rest with reassociated adds), so a total of three or
more terms may differ in the last bits: scores are held within 1e-6
relative (a few f32 ulps). Where two candidates' totals lie that close,
XLA's rounding can split what the port ties, or the reverse: such
near-ties may swap (ROADMAP C-15), and nothing else may differ.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu import native
from rag_dpo_tpu.evals.synthetic import build_synthetic_corpus
from rag_dpo_tpu.ops.postings import PostingsIndex as JPostingsIndex
from rag_dpo_tpu.ops.postings import (
    postings_candidates_topk as j_postings_candidates_topk,
)
from rag_dpo_tpu.retrieval.bm25 import (
    build_bm25_stats,
    build_ell_corpus_tf,
    impacts_from_tf,
    tokenize_corpus,
)
from rag_dpo_tpu_torch import native as tnative
from rag_dpo_tpu_torch.ops.postings import (
    PostingsIndex,
    postings_candidates_topk,
)

DATASET = (pathlib.Path(__file__).resolve().parent.parent / "rag_dpo_tpu"
           / "evals" / "data" / "qa_dataset.json")
SCORE_TOL = dict(rtol=1e-6, atol=0)


def assert_same_up_to_near_ties(ts, ti, js, ji):
    """Equal ids, except that entries whose JAX scores lie within 1e-6
    relative of each other may trade places (also across the k-th slot).
    Returns the number of slots that differ."""
    ts, ti, js, ji = (np.asarray(x) for x in (ts, ti, js, ji))
    np.testing.assert_allclose(ts, js, **SCORE_TOL)
    n_diff = 0
    for q in range(ti.shape[0]):
        jpos = {int(d): p for p, d in enumerate(ji[q])}
        for p in np.nonzero(ti[q] != ji[q])[0]:
            n_diff += 1
            ref = js[q, jpos[int(ti[q, p])]] if int(ti[q, p]) in jpos \
                else js[q, -1]
            assert abs(ref - js[q, p]) <= 1e-6 * abs(js[q, p]), (
                q, p, ti[q, p], ji[q, p], ref, js[q, p])
    return n_diff


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bm25():
    """The synthetic corpus's BM25 ELL at width 24, and 12 questions as
    16-term queries."""
    dataset = json.loads(DATASET.read_text())
    chunks = build_synthetic_corpus(dataset)
    toks = tokenize_corpus([c["text"] for c in chunks])
    stats = build_bm25_stats(toks)
    terms, tf, dl = build_ell_corpus_tf(toks, stats, 24)
    pairs = [stats.query_terms(d["question"], 16) for d in dataset[:12]]
    return dict(terms=terms, impacts=impacts_from_tf(tf, dl, stats),
                vocab=len(stats.vocab), qt=np.stack([p[0] for p in pairs]),
                qw=np.stack([p[1] for p in pairs]).astype(np.float32))


def _random_case(seed):
    """bench.py's recipe at a small size: uniform terms (repeats allowed)
    and abs-normal impacts."""
    rng = np.random.default_rng(seed)
    terms = rng.integers(0, 400, (3000, 24)).astype(np.int32)
    terms[::7, 20:] = -1
    impacts = np.abs(rng.standard_normal((3000, 24))).astype(np.float32)
    qt = rng.integers(0, 400, (20, 16)).astype(np.int32)
    qt[::3, 10:] = -2
    qw = np.abs(rng.standard_normal((20, 16))).astype(np.float32)
    return dict(terms=terms, impacts=impacts, vocab=400, qt=qt, qw=qw)


def _jax_build(case, cap, monkeypatch):
    """JAX's build; both packages on the numpy path from here on."""
    monkeypatch.setattr(native, "is_available", lambda: False)
    monkeypatch.setattr(tnative, "is_available", lambda: False)
    return JPostingsIndex.build(case["terms"], case["impacts"],
                                vocab_size=case["vocab"], cap=cap)


@pytest.mark.parametrize("cap", [64, 8])
def test_build_arrays_equal_jax(bm25, cap, monkeypatch):
    j = _jax_build(bm25, cap, monkeypatch)
    t = PostingsIndex.build(bm25["terms"], bm25["impacts"],
                            vocab_size=bm25["vocab"], cap=cap)
    np.testing.assert_array_equal(t.post_docs, j.post_docs)
    np.testing.assert_array_equal(t.post_impacts, j.post_impacts)
    assert (t.cap, t.n_docs) == (j.cap, j.n_docs)
    docs, imps = t.device_arrays("cpu")
    assert docs.dtype == torch.int32 and imps.dtype == torch.float32


@pytest.mark.parametrize("source,cap,n_cand,k,with_pen", [
    ("bm25", 64, 64, 40, False),
    ("bm25", 64, 64, 40, True),
    ("bm25", 16, 512, 100, True),   # pool wider than the postings, k > C
    ("random", 256, 64, 40, False),
    ("random", 256, 64, 40, True),
    ("random", 32, 16, 10, False),
])
def test_candidates_topk_matches_jax(bm25, monkeypatch, source, cap, n_cand,
                                     k, with_pen):
    case = bm25 if source == "bm25" else _random_case(cap + n_cand)
    pidx = _jax_build(case, cap, monkeypatch)
    n = case["terms"].shape[0]
    pen = None
    if with_pen:
        pen = np.zeros(n, np.float32)
        pen[np.random.default_rng(3).choice(n, n // 5, replace=False)] = -1e4
    js, ji = j_postings_candidates_topk(
        *pidx.device_arrays(), jnp.asarray(case["terms"]),
        jnp.asarray(case["impacts"]), jnp.asarray(case["qt"]),
        jnp.asarray(case["qw"]), k=k, n_candidates=n_cand,
        penalty=None if pen is None else jnp.asarray(pen))
    t = PostingsIndex.build(case["terms"], case["impacts"],
                            vocab_size=case["vocab"], cap=cap)
    ts, ti = postings_candidates_topk(
        *t.device_arrays("cpu"), torch.from_numpy(case["terms"]),
        torch.from_numpy(case["impacts"]), torch.from_numpy(case["qt"]),
        torch.from_numpy(case["qw"]), k=k, n_candidates=n_cand,
        penalty=None if pen is None else torch.from_numpy(pen))
    assert ti.dtype == torch.int32 and ts.shape == (case["qt"].shape[0], k)
    n_diff = assert_same_up_to_near_ties(ts, ti, js, ji)
    assert n_diff <= 0.1 * int((ti >= 0).sum()), n_diff
    assert (ti >= 0).any()
