"""The port's DeviceIndex against the JAX package's, through checkpoints.

A JAX `DeviceIndex` checkpoint (saved with `DeviceIndex.save`) loads in the
port, and the port's searches return the same row ids: dense approx,
exact and filtered, sparse unfiltered (the ELL kernel's plain twin) and
filtered. Both indexes run the same add/delete/compact sequence.
"""

import json
import pathlib

import numpy as np
import pytest

from rag_dpo_tpu.evals.synthetic import build_synthetic_corpus
from rag_dpo_tpu.index import DeviceIndex as JDeviceIndex
from rag_dpo_tpu.index import IndexConfig as JIndexConfig
from rag_dpo_tpu.retrieval.bm25 import (
    build_bm25_stats,
    build_ell_corpus_tf,
    impacts_from_tf,
    tokenize_corpus,
)
from rag_dpo_tpu_torch.index import DeviceIndex

DATASET = (pathlib.Path(__file__).resolve().parent.parent / "rag_dpo_tpu"
           / "evals" / "data" / "qa_dataset.json")


@pytest.fixture(scope="module")
def corpus():
    chunks = build_synthetic_corpus(json.loads(DATASET.read_text()))
    toks = tokenize_corpus([c["text"] for c in chunks])
    stats = build_bm25_stats(toks)
    terms, tf, dl = build_ell_corpus_tf(toks, stats, 24)
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((len(chunks), 16)).astype(np.float32)
    dense[7] = dense[3]           # duplicate rows: exact dense ties
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    metas = [{k: v for k, v in c.items() if k != "chunk_id"} for c in chunks]
    return dict(ids=[c["chunk_id"] for c in chunks], dense=dense,
                metas=metas, terms=terms, tf=tf, dl=dl, stats=stats,
                impacts=impacts_from_tf(tf, dl, stats), toks=toks)


def _fill(index, c, lo, hi):
    index.add(c["ids"][lo:hi], c["dense"][lo:hi], c["metas"][lo:hi],
              c["terms"][lo:hi], c["impacts"][lo:hi], tf=c["tf"][lo:hi],
              dl=c["dl"][lo:hi])
    index.bm25_stats = c["stats"]


def _queries(c):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    q[2] = c["dense"][3]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pairs = [c["stats"].query_terms(t) for t in (
        "responsable de traitement obligations",
        "durée de conservation des données",
        "transfert hors Union européenne")]
    return q, np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _assert_same_searches(jidx, idx, c):
    q, qt, qw = _queries(c)
    where = {"nature": {"$in": ["DOCTRINE", "MIXTE"]}}
    for kw in ({}, {"exact": True}, {"where": where},
               {"where": where, "exact": True}):
        js, ji = jidx.search_dense(q, 40, **kw)
        ts, ti = idx.search_dense(q, 40, **kw)
        np.testing.assert_array_equal(ti, ji, err_msg=str(kw))
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)
    for kw in ({}, {"where": where}):
        js, ji = jidx.search_sparse(qt, qw, 40, **kw)
        ts, ti = idx.search_sparse(qt, qw, 40, **kw)
        np.testing.assert_array_equal(ti, ji, err_msg=str(kw))
        np.testing.assert_array_equal(ts, js)


def test_jax_checkpoint_loads_and_searches_identically(corpus, tmp_path):
    jidx = JDeviceIndex(JIndexConfig(dim=16, ell_width=24))
    _fill(jidx, corpus, 0, len(corpus["ids"]))
    jidx.save(tmp_path / "ckpt")
    idx = DeviceIndex.load(tmp_path / "ckpt", device="cpu")
    assert idx.ids == jidx.ids and idx.n_rows == 212
    assert idx.bm25_stats.vocab == corpus["stats"].vocab
    _assert_same_searches(jidx, idx, corpus)
    # and the port's checkpoint loads back into the JAX package
    idx.save(tmp_path / "back")
    again = JDeviceIndex.load(tmp_path / "back")
    np.testing.assert_array_equal(again._impacts, jidx._impacts)
    _assert_same_searches(again, idx, corpus)


def test_add_delete_compact_track_the_jax_index(corpus):
    jidx = JDeviceIndex(JIndexConfig(dim=16, ell_width=24))
    idx = DeviceIndex(_port_config(), device="cpu")
    for index in (jidx, idx):
        _fill(index, corpus, 0, 150)
        _fill(index, corpus, 120, 212)    # upserts 120..149, appends rest
        index.delete(corpus["ids"][10:30] + ["missing"])
    assert len(idx) == len(jidx) == 192
    _assert_same_searches(jidx, idx, corpus)   # tombstones stripped
    for index in (jidx, idx):
        index.compact()
    assert idx.ids == jidx.ids
    _assert_same_searches(jidx, idx, corpus)


def _port_config():
    from rag_dpo_tpu_torch.index import IndexConfig

    return IndexConfig(dim=16, ell_width=24)


def test_unported_engines_raise(corpus):
    """Int8 storage and the postings engine are ported (slice 4), and the
    on-card int8 refine too (slice 9): no engine raises any more; an int8
    index with `device_refine` builds and finds its own rows."""
    from rag_dpo_tpu_torch.index import IndexConfig

    refine = DeviceIndex(IndexConfig(dim=16, ell_width=24, row_block=64,
                                     quantize_int8=True, device_refine=True),
                         device="cpu")
    _fill(refine, corpus, 0, 20)
    _, rows = refine.search_dense(corpus["dense"][[3, 11]], 5)
    assert rows[:, 0].tolist() == [3, 11]
    DeviceIndex(IndexConfig(dim=16, quantize_int8=True), device="cpu")
    idx = DeviceIndex(_port_config(), device="cpu")
    _fill(idx, corpus, 0, 20)
    heavy = np.full((8, 32), -2, np.int32)   # Q·T > 128: the postings engine
    s, i = idx.search_sparse(heavy, np.zeros((8, 32), np.float32), 10)
    assert i.shape == (8, 10) and (i == -1).all() and (s == -1e30).all()
