"""The MaxSim rerank, port against JAX, on all 48 hermetic questions.

Both stacks index the synthetic corpus with ColBERT storage
(`with_colbert=True, colbert_len=96`, as the hermetic replay's MaxSim arm
does) from the same Flax-initialised weights exported from JAX (ROADMAP
C-3). For every question both hybrid retrievers give the same 40
candidates, and both `MaxSimReranker`s must give the same top-10 chunk
ids, with scores within 1e-5: the scores are length-normalised MaxSim
sums of f32 encoders ~1e-6 apart over f16 rows.
"""

import json

import jax
import numpy as np
import pytest
import torch

from rag_dpo_tpu import native
from rag_dpo_tpu.evals.synthetic import build_synthetic_corpus
from rag_dpo_tpu.ingest.indexer import CorpusIndexer as JCorpusIndexer
from rag_dpo_tpu.models import BgeM3Config as JBgeM3Config
from rag_dpo_tpu.models import EncoderConfig as JEncoderConfig
from rag_dpo_tpu.providers import Embedder as JEmbedder
from rag_dpo_tpu.providers import EmbedderConfig as JEmbedderConfig
from rag_dpo_tpu.retrieval import HybridRetriever as JHybridRetriever
from rag_dpo_tpu.retrieval.reranker import MaxSimReranker as JMaxSimReranker
from rag_dpo_tpu_torch import native as tnative
from rag_dpo_tpu_torch.evals.train_encoder import QA_DATASET
from rag_dpo_tpu_torch.ingest import CorpusIndexer
from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
from rag_dpo_tpu_torch.ops import _kernels
from rag_dpo_tpu_torch.providers import Embedder, EmbedderConfig
from rag_dpo_tpu_torch.retrieval import HybridRetriever
from rag_dpo_tpu_torch.retrieval.reranker import MaxSimReranker

SCORE_TOL = 1e-5
NEAR_TIE = 1e-6


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: each pytest-xdist worker would otherwise start
    one per core, and oversubscribed, torch's CPU ops run ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_maxsim_rerank_top10_matches_jax_on_all_48_questions():
    dataset = json.loads(QA_DATASET.read_text())
    chunks = build_synthetic_corpus(dataset)
    jemb = JEmbedder(JEmbedderConfig(model=JBgeM3Config(
        encoder=JEncoderConfig.tiny(use_flash_attention=False),
        colbert_dim=32)))
    emb = Embedder(EmbedderConfig(model=BgeM3Config(
        encoder=EncoderConfig.tiny(use_flash_attention=False),
        colbert_dim=32)), params=jax.tree.map(np.asarray, jemb.load()),
        device="cpu")
    kw = dict(ell_width=48, with_colbert=True, colbert_len=96)
    # BM25 impacts from the Python path on both sides (ROADMAP C-8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "is_available", lambda: False)
        mp.setattr(tnative, "is_available", lambda: False)
        jindex, jstats, _ = JCorpusIndexer(jemb, **kw).build(chunks)
        index, stats, _ = CorpusIndexer(emb, **kw).build(chunks)
    jret = JHybridRetriever(jindex, jemb, bm25_stats=jstats)
    ret = HybridRetriever(index, emb, bm25_stats=stats)
    jrr, rr = JMaxSimReranker(jindex, jemb), MaxSimReranker(index, emb)

    assert len(dataset) == 48
    mismatches, worst = [], 0.0
    plain_before = _kernels.PLAIN_ON_CUDA["maxsim"]
    for item in dataset:
        q = item["question"]
        jc = jret.retrieve_candidates(q, n_candidates=40)
        tc = ret.retrieve_candidates(q, n_candidates=40)
        assert [c.row for c in tc] == [c.row for c in jc], q
        want, got = jrr.rerank(q, jc, top_k=10), rr.rerank(q, tc, top_k=10)
        assert len(got) == len(want) == 10
        ws = np.array([c.rerank_score for c in want])
        gs = np.array([c.rerank_score for c in got])
        assert all(c.score == c.rerank_score for c in got)
        assert (np.diff(gs) <= 0).all(), q      # best first
        if [c.chunk_id for c in got] != [c.chunk_id for c in want]:
            mismatches.append((item["id"], float((-np.diff(ws)).min())))
            continue
        worst = max(worst, float(np.abs(gs - ws).max()))
    # measured: the same ids on every question, scores within 5.2e-06
    assert not mismatches, (
        "top-10 ids differ on (question, smallest gap between JAX's "
        f"neighbouring scores): {mismatches}; a gap <= {NEAR_TIE} is a "
        "near-tie swap of f32 rounding, anything larger a fault")
    assert worst <= SCORE_TOL, worst
    assert _kernels.PLAIN_ON_CUDA["maxsim"] == plain_before
