"""The index at corpus scale, on the CPU: int8 storage and the postings
engine of the port's `DeviceIndex` against the JAX package's.

Int8 (ROADMAP C-14): the port ranks candidates with the pooled-max sweep
(bf16 queries × int8 rows, the max of each strided group of 64 rows), the
reference with int8 × int8 scores; both re-score their candidates exactly
on the host. So they agree by recall, not id for id. A group keeps one
row: a true top-10 row is lost when a better one shares its group, about
45·64/N of the rows per query (0.2% at the 131,072 rows here, 0.9% at
32,768, 0.03% at 1M), so the test index is 131,072 × 64 and the test
requires recall@10 ≥ 0.99 against JAX, while every returned score must be
the f32 dot against its f16 row (within 1e-6).

Postings: ids as JAX's up to near-ties of the BM25 totals (ROADMAP C-15,
see `tests/test_torch_postings.py`), on the synthetic corpus with
`postings_threshold` set low.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from rag_dpo_tpu import native
from rag_dpo_tpu.evals.synthetic import build_synthetic_corpus
from rag_dpo_tpu.index import DeviceIndex as JDeviceIndex
from rag_dpo_tpu.index import IndexConfig as JIndexConfig
from rag_dpo_tpu.retrieval.bm25 import (
    build_bm25_stats,
    build_ell_corpus_tf,
    impacts_from_tf,
    tokenize_corpus,
)
from rag_dpo_tpu_torch.index import DeviceIndex, IndexConfig
from test_torch_postings import assert_same_up_to_near_ties

DATASET = (pathlib.Path(__file__).resolve().parent.parent / "rag_dpo_tpu"
           / "evals" / "data" / "qa_dataset.json")
N_INT8, DIM = 131_072, 64
MIN_RECALL = 0.99


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _recall(got, want, k=10):
    return float(np.mean([len(set(g[:k]) & set(w[:k]) - {-1})
                          / max(1, len(set(w[:k]) - {-1}))
                          for g, w in zip(got, want)]))


@pytest.fixture(scope="module")
def int8_pair():
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((N_INT8, DIM)).astype(np.float32)
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    ids = [f"c{i}" for i in range(N_INT8)]
    metas = [{"nature": "DOCTRINE" if i % 3 else "MIXTE"}
             for i in range(N_INT8)]
    jidx = JDeviceIndex(JIndexConfig(dim=DIM, ell_width=4,
                                     quantize_int8=True))
    idx = DeviceIndex(IndexConfig(dim=DIM, ell_width=4, quantize_int8=True),
                      device="cpu")
    for index in (jidx, idx):
        index.add(ids, dense, metas)
        index.delete([f"c{i}" for i in range(0, N_INT8, 97)])
    q = rng.standard_normal((64, DIM)).astype(np.float32)
    q[:4] = dense[[5, 6, 7, 8]]           # planted neighbours
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return jidx, idx, q


def _assert_exact_scores(idx, q, s, i):
    ok = i >= 0
    rows = idx._dense[np.where(ok, i, 0)].astype(np.float32)
    want = np.einsum("qd,qcd->qc", q, rows)
    np.testing.assert_allclose(s[ok], want[ok], rtol=0, atol=1e-6)
    assert (s[~ok] == -1e30).all()


@pytest.mark.parametrize("where", [None, {"nature": "MIXTE"}])
def test_int8_search_matches_jax_by_recall(int8_pair, where):
    jidx, idx, q = int8_pair
    js, ji = jidx.search_dense(q, 10, where=where)
    ts, ti = idx.search_dense(q, 10, where=where)
    assert ts.shape == ti.shape == (64, 10) and ts.dtype == np.float32
    assert _recall(ti, ji) >= MIN_RECALL
    _assert_exact_scores(idx, q, ts, ti)
    dead = ~idx._alive
    assert not dead[ti[ti >= 0]].any()
    if where is None:
        assert (ti[:4, 0] == [5, 6, 7, 8]).all()
    else:
        assert all(idx.meta._docs[r]["nature"] == "MIXTE"
                   for r in ti[ti >= 0])
    # `exact` does not apply to int8 storage, as in JAX
    es, ei = idx.search_dense(q[:8], 10, where=where, exact=True)
    np.testing.assert_array_equal(ei, ti[:8])


def test_int8_head_of_top40_recall(int8_pair):
    """The 1M recipe's measure: the head of the refined top-40."""
    jidx, idx, q = int8_pair
    _, ji = jidx.search_dense(q, 40)
    ts, ti = idx.search_dense(q, 40)
    assert _recall(ti, ji) >= MIN_RECALL
    _assert_exact_scores(idx, q, ts, ti)


def test_int8_checkpoints_cross_load(int8_pair, tmp_path):
    jidx, idx, q = int8_pair
    jidx.save(tmp_path / "jax")
    loaded = DeviceIndex.load(tmp_path / "jax", device="cpu")
    assert loaded.config.quantize_int8 and loaded.n_rows == N_INT8
    _, li = loaded.search_dense(q, 10)
    _, ji = jidx.search_dense(q, 10)
    assert _recall(li, ji) >= MIN_RECALL
    idx.save(tmp_path / "port")
    back = JDeviceIndex.load(tmp_path / "port")
    assert back.config.quantize_int8 and back.n_rows == N_INT8
    _, bi = back.search_dense(q, 10)
    np.testing.assert_array_equal(bi, ji)


def test_device_refine_still_raises():
    """The on-card int8 refine is ported (slice 9): `device_refine` no longer
    raises; it builds and searches on the CPU, by one sweep and by forced
    row blocks (`tests/test_torch_quantize_int8.py` holds it to JAX)."""
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((300, 16)).astype(np.float32)
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    for blocks in (0, 64):
        idx = DeviceIndex(IndexConfig(dim=16, row_block=64, quantize_int8=True,
                                      device_refine=True,
                                      sweep_block_rows=blocks), device="cpu")
        idx.add([f"r{i}" for i in range(300)], dense)
        s, i = idx.search_dense(dense[[0, 150, 299]], 5)
        assert i[:, 0].tolist() == [0, 150, 299]
        assert (np.diff(s, axis=1) <= 0).all()


@pytest.fixture(scope="module")
def bm25_pair():
    chunks = build_synthetic_corpus(json.loads(DATASET.read_text()))
    toks = tokenize_corpus([c["text"] for c in chunks])
    stats = build_bm25_stats(toks)
    terms, tf, dl = build_ell_corpus_tf(toks, stats, 24)
    impacts = impacts_from_tf(tf, dl, stats)
    rng = np.random.default_rng(2)
    dense = rng.standard_normal((len(chunks), 16)).astype(np.float32)
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    ids = [c["chunk_id"] for c in chunks]
    metas = [{k: v for k, v in c.items() if k != "chunk_id"} for c in chunks]
    questions = [d["question"] for d in json.loads(DATASET.read_text())[:9]]
    pairs = [stats.query_terms(x, 16) for x in questions]
    qt = np.stack([p[0] for p in pairs])
    qw = np.stack([p[1] for p in pairs]).astype(np.float32)
    out = {}
    # above 100 rows every sparse search takes the postings engine; the
    # default threshold keeps the ELL kernel but for Q·T > 128
    for name, threshold in (("low", 100), ("default", 100_000)):
        kw = dict(dim=16, ell_width=24, postings_threshold=threshold,
                  postings_cap=64, postings_candidates=64)
        jidx = JDeviceIndex(JIndexConfig(**kw))
        idx = DeviceIndex(IndexConfig(**kw), device="cpu")
        for index in (jidx, idx):
            index.add(ids, dense, metas, terms, impacts, tf=tf, dl=dl)
            index.bm25_stats = stats
            index.delete(ids[40:60])
        out[name] = (jidx, idx)
    return out, qt, qw


@pytest.mark.parametrize("threshold,n_q,where", [
    ("low", 3, None),                                      # unfiltered
    ("low", 3, {"nature": {"$in": ["DOCTRINE", "MIXTE"]}}),  # masked
    ("default", 9, None),                                  # Q·T = 144
    ("default", 9, {"nature": "DOCTRINE"}),
])
def test_postings_branches_match_jax(bm25_pair, monkeypatch, threshold, n_q,
                                     where):
    monkeypatch.setattr(native, "is_available", lambda: False)
    pairs, qt, qw = bm25_pair
    jidx, idx = pairs[threshold]
    js, ji = jidx.search_sparse(qt[:n_q], qw[:n_q], 40, where=where)
    ts, ti = idx.search_sparse(qt[:n_q], qw[:n_q], 40, where=where)
    assert ti.shape == (n_q, 40)
    assert_same_up_to_near_ties(ts, ti, js, ji)
    assert (ti >= 0).sum() == (ji >= 0).sum() >= 5 * n_q
    dead = ~idx._alive
    assert not dead[ti[ti >= 0]].any()
    if where is not None:
        mask = np.zeros(idx.n_rows, bool)
        from rag_dpo_tpu_torch.index.metadata import compile_filter

        mask[:] = compile_filter(idx.meta, where)
        assert mask[ti[ti >= 0]].all()
