"""The index at corpus scale, on the CPU: int8 storage and the postings
engine of the port's `DeviceIndex` against the JAX package's.

Int8: both stores quantize the queries per row, rank every row by its
int8 × int8 score × both scales + the penalty, keep the best min(4k, n_pad)
and re-score those exactly on the host against the f16 rows (ROADMAP C-14,
closed). So they return the same ids; where two refined scores are equal,
the order follows the candidates' order, which JAX's CPU `approx_max_k`
does not keep stable (C-2), so ids may swap only inside such a tie. Every
returned score is the f32 dot against its f16 row (within 1e-6).

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
from rag_dpo_tpu_torch import native as tnative
from rag_dpo_tpu_torch.index import DeviceIndex, IndexConfig
from test_torch_postings import assert_same_up_to_near_ties

DATASET = (pathlib.Path(__file__).resolve().parent.parent / "rag_dpo_tpu"
           / "evals" / "data" / "qa_dataset.json")
N_INT8, DIM = 131_072, 64


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def assert_ids_equal_but_ties(ti, ts, ji, js):
    """The same ids, but where JAX's refined score ties exactly with a
    neighbour's (C-2: the order inside such a tie is JAX's unstable
    selection's); the same scores within 1e-6 everywhere."""
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
    tie = np.diff(js, axis=1) == 0
    tie = np.pad(tie, ((0, 0), (0, 1))) | np.pad(tie, ((0, 0), (1, 0)))
    assert not ((ti != ji) & ~tie).any()
    for a, b, t in zip(ti, ji, tie):
        assert sorted(a[t]) == sorted(b[t])


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
    """Id for id since the store ranks by int8 × int8 as JAX does (C-14),
    filtered and not: recall@10 is 1."""
    jidx, idx, q = int8_pair
    js, ji = jidx.search_dense(q, 10, where=where)
    ts, ti = idx.search_dense(q, 10, where=where)
    assert ts.shape == ti.shape == (64, 10) and ts.dtype == np.float32
    assert_ids_equal_but_ties(ti, ts, ji, js)
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
    """The 1M recipe's measure, the refined top-40: JAX's ids."""
    jidx, idx, q = int8_pair
    js, ji = jidx.search_dense(q, 40)
    ts, ti = idx.search_dense(q, 40)
    assert_ids_equal_but_ties(ti, ts, ji, js)
    _assert_exact_scores(idx, q, ts, ti)


@pytest.mark.parametrize("k", [10, 40])
def test_int8_default_store_ranks_as_jax(k):
    """ROADMAP C-14 at 32,768 unit rows × 64, 64 queries: the port's default
    int8 store (no `device_refine`) returns JAX's ids but inside exact ties
    and its scores within 1e-6. The pooled sweep it ran before lost ~0.9%
    of a query's top-10 here (a group of 64 rows keeps one)."""
    rng = np.random.default_rng(32 + k)
    n = 32_768
    dense = rng.standard_normal((n, DIM)).astype(np.float32)
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    q = rng.standard_normal((64, DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ids = [f"r{i}" for i in range(n)]
    jidx = JDeviceIndex(JIndexConfig(dim=DIM, ell_width=4,
                                     quantize_int8=True))
    idx = DeviceIndex(IndexConfig(dim=DIM, ell_width=4, quantize_int8=True),
                      device="cpu")
    for index in (jidx, idx):
        index.add(ids, dense)
    js, ji = jidx.search_dense(q, k)
    ts, ti = idx.search_dense(q, k)
    assert ti.shape == (64, k) and (ti >= 0).all()
    assert_ids_equal_but_ties(ti, ts, ji, js)
    _assert_exact_scores(idx, q, ts, ti)


def test_int8_checkpoints_cross_load(int8_pair, tmp_path):
    jidx, idx, q = int8_pair
    jidx.save(tmp_path / "jax")
    loaded = DeviceIndex.load(tmp_path / "jax", device="cpu")
    assert loaded.config.quantize_int8 and loaded.n_rows == N_INT8
    ls, li = loaded.search_dense(q, 10)
    js, ji = jidx.search_dense(q, 10)
    assert_ids_equal_but_ties(li, ls, ji, js)
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
    monkeypatch.setattr(tnative, "is_available", lambda: False)
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
