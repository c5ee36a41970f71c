"""The port's serving layer on the CPU (slice 13): the micro-batcher, the
coalesced query encode and rerank, `batched_dense_search` and
`DeviceIndex.warm`.

Coalescing changes the shapes of the encoders' GEMMs, so a caller's
coalesced vector or score may differ from its direct one in the last bits
(rows stay independent under the per-row key mask; pad rows have length
1): each is held to the direct one within 1e-5. The mean batch must pass
1 with one-row requests, which only coalescing gives. `tests/
test_batcher.py`'s cases of the batcher itself run on the port's copy.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import test_batcher as jbatcher
from rag_dpo_tpu_torch.index import DeviceIndex, IndexConfig
from rag_dpo_tpu_torch.ops import _kernels
from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
from rag_dpo_tpu_torch.providers import Embedder, EmbedderConfig
from rag_dpo_tpu_torch.retrieval.reranker import (
    CrossEncoderReranker,
    default_reranker,
)
from rag_dpo_tpu_torch.serving import (
    MicroBatcher,
    batched_dense_search,
    batcher_stats,
)

COALESCED_TOL = 1e-5
N_THREADS = 8
TEXTS = [
    "Quel est le délai de notification d'une violation de données ?",
    "Faut-il un registre des traitements ?",
    "AIPD",
    "Quelles sont les obligations du sous-traitant au titre de l'article "
    "28 du RGPD, et quelles clauses le contrat doit-il contenir ?",
    "droit d'accès",
    "Combien de temps conserver les données de vidéosurveillance ?",
    "Le DPO peut-il être sanctionné ?",
    "transfert hors UE",
]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _embedder():
    return Embedder(EmbedderConfig(
        model=BgeM3Config(encoder=EncoderConfig.tiny(), colbert_dim=32)),
        device="cpu")


def _together(fn, n: int = N_THREADS) -> dict:
    """fn(i) in n threads released at once; {i: result}."""
    gate = threading.Barrier(n)
    out, errors = {}, []

    def run(i):
        gate.wait()
        try:
            out[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "a caller is still waiting"
    if errors:
        raise errors[0]
    return out


def test_launch_counts_lose_no_update_under_threads(monkeypatch):
    """Serving launches kernels from the batchers' and the agent's worker
    threads at once: with the interpreter switching threads every
    microsecond, every count must land. (A bare `+= 1` on a dict item is a
    read-modify-write that the language does not promise to be atomic;
    CPython 3.12 happened to lose none in this harness.)"""
    monkeypatch.setattr(_kernels, "LAUNCHES", {"flash_fwd": 0})
    monkeypatch.setattr(_kernels, "PLAIN_ON_CUDA", {"flash_fwd": 0})
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _together(lambda i: [(_kernels.count_launch("flash_fwd"),
                              _kernels.count_plain("flash_fwd"))
                             for _ in range(20_000)], n=16)
    finally:
        sys.setswitchinterval(interval)
    assert _kernels.LAUNCHES["flash_fwd"] == 16 * 20_000
    assert _kernels.PLAIN_ON_CUDA["flash_fwd"] == 16 * 20_000


@pytest.mark.parametrize("case", [
    "test_batcher_aggregates_concurrent_requests",
    "test_batcher_isolates_keys_and_propagates_errors",
    "test_batcher_splits_oversized_requests",
])
def test_batcher_case_on_the_port(case, monkeypatch):
    monkeypatch.setattr(jbatcher, "MicroBatcher", MicroBatcher)
    getattr(jbatcher, case)()


def test_coalesced_query_vectors_equal_direct():
    emb = _embedder()
    direct = emb.embed_queries(TEXTS)
    np.testing.assert_array_equal(emb.embed_query(TEXTS[2]), direct[2])
    emb.enable_query_batching(max_batch=64, max_wait_ms=50.0)
    emb.enable_query_batching(max_batch=8)          # idempotent
    got = _together(lambda i: emb.embed_queries([TEXTS[i]]))
    for i in range(N_THREADS):
        assert got[i].shape == (1, emb.dim)
        np.testing.assert_allclose(got[i][0], direct[i], rtol=0,
                                   atol=COALESCED_TOL)
    stats = batcher_stats(emb._query_batcher)
    assert stats["n_requests"] == N_THREADS
    assert stats["mean_batch"] > 1 and stats["n_fallbacks"] == 0
    # one caller's three rows through the batcher
    np.testing.assert_allclose(emb.embed_queries(TEXTS[:3]), direct[:3],
                               rtol=0, atol=COALESCED_TOL)
    emb._query_batcher.close()


def test_unload_rebuilds_the_seeded_weights():
    emb = _embedder()
    before = emb.embed_queries(TEXTS[:2])
    emb.unload()
    assert emb.model is None
    np.testing.assert_array_equal(emb.embed_queries(TEXTS[:2]), before)


def test_coalesced_pair_scores_equal_direct():
    rr = CrossEncoderReranker(device="cpu")
    pairs = [[(TEXTS[i], TEXTS[(i + j) % len(TEXTS)]) for j in range(3)]
             for i in range(N_THREADS)]
    direct = [rr.score_pairs(p) for p in pairs]
    rr.enable_pair_batching(max_batch=64, max_wait_ms=50.0)
    got = _together(lambda i: rr.score_pairs(pairs[i]))
    for i in range(N_THREADS):
        np.testing.assert_allclose(got[i], direct[i], rtol=0,
                                   atol=COALESCED_TOL)
    s = rr._pair_batcher.stats
    assert s.n_requests == N_THREADS and s.n_device_calls < N_THREADS
    rr._pair_batcher.close()


def test_default_reranker_batches_pairs_on_request():
    emb = _embedder()
    assert default_reranker(emb)._pair_batcher is None
    rr = default_reranker(emb, rerank_batch=16)
    assert rr._pair_batcher.max_batch == 16
    assert rr.device == emb.device
    rr._pair_batcher.close()


def _index(n=300, dim=32, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, dim)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    terms = rng.integers(0, 40, (n, 4)).astype(np.int32)
    imps = np.abs(rng.standard_normal((n, 4))).astype(np.float32)
    idx = DeviceIndex(IndexConfig(dim=dim, ell_width=4, row_block=64),
                      device="cpu")
    idx.add([f"c{i}" for i in range(n)], e,
            [{"nature": "GUIDE" if i % 2 else "SANCTION"} for i in range(n)],
            terms, imps)
    return idx, e, terms


def test_batched_dense_search_matches_direct():
    """As `tests/test_batcher.py::test_batched_dense_search_matches_direct`
    holds the JAX store: ids equal the direct search's exactly. The scores
    of a padded batch may differ in the last bit (the CPU product's
    blocking follows the batch), so within 1e-6."""
    idx, e, _ = _index()
    search = batched_dense_search(idx, max_batch=32, max_wait_ms=50.0)
    rows_of = [3, 77, 150, 299, 9]
    got = _together(
        lambda i: search(e[[rows_of[i]]], 5,
                         where={"nature": "GUIDE"} if i == 4 else None),
        n=len(rows_of))
    for i, r in enumerate(rows_of[:4]):
        ds, drows = idx.search_dense(e[[r]], 5)
        s, rows = got[i]
        assert rows[0, 0] == r and rows.tolist() == drows.tolist()
        np.testing.assert_allclose(s, ds, rtol=0, atol=1e-6)
    for r in got[4][1][0]:
        if r >= 0:
            assert idx.meta.row(int(r))["nature"] == "GUIDE"
    assert search.batcher.stats.n_requests == len(rows_of)
    search.batcher.close()


def test_warm_leaves_results_unchanged():
    empty = DeviceIndex(IndexConfig(dim=32, ell_width=4, row_block=64),
                        device="cpu")
    empty.warm()
    fresh, e, terms = _index()
    q, qt = e[:5], terms[:5].copy()
    qw = np.ones(qt.shape, np.float32)
    want = (fresh.search_dense(q, 10), fresh.search_sparse(qt, qw, 10))
    warmed, _, _ = _index()
    warmed.warm(batch_sizes=(1, 8, 64))
    empty.add(list(fresh.ids), e, terms=terms, impacts=fresh._impacts)
    for idx in (warmed, empty):
        got = (idx.search_dense(q, 10), idx.search_sparse(qt, qw, 10))
        for (gs, gi), (ws, wi) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(warmed.dense_vectors([4, 0]),
                                  warmed._dense[[4, 0]].astype(np.float32))
