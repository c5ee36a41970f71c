"""The port's agent graph against the JAX package's (slice 13).

`tests/test_agent.py`'s corpus and index in both packages, the port's
encoder loaded with the Flax weights (exported as numpy, as
`models/convert.py` carries them), the deterministic fake LLM on both
sides. Each question of `tests/test_agent.py` goes through both
`create_agent_pipeline(...).query`, with the completeness loop and the
expert refinement on and off, and with the refusing and low-coverage
providers of its refusal and re-retrieval cases: the answer text, the
cited sources (their chunk ids), the intent and topics, the node trace
and every other extra must be equal. The fused candidates' scores must
agree within 1e-6 relative and the cross-encoder's within 1e-5 (f32
encoders of two frameworks, ~1e-6 apart). The JAX side runs attention in
reference mode, as its own agent tests do; the port runs its flash
kernel's plain twin.
"""

import json

import jax
import numpy as np
import pytest
import torch

import rag_dpo_tpu.providers as jproviders
import rag_dpo_tpu_torch.providers as tproviders
from rag_dpo_tpu.agent import create_agent_pipeline as j_create_agent
from rag_dpo_tpu.index import DeviceIndex as JDeviceIndex
from rag_dpo_tpu.index import IndexConfig as JIndexConfig
from rag_dpo_tpu.models import BgeM3Config as JBgeM3Config
from rag_dpo_tpu.models import EncoderConfig as JEncoderConfig
from rag_dpo_tpu.rag.topics import TopicMatcher as JTopicMatcher
from rag_dpo_tpu.retrieval import bm25 as jbm25
from rag_dpo_tpu.retrieval.reranker import (
    CrossEncoderReranker as JCrossEncoderReranker,
)
from rag_dpo_tpu_torch.agent import RAGAgentPipeline, create_agent_pipeline
from rag_dpo_tpu_torch.index import DeviceIndex, IndexConfig
from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
from rag_dpo_tpu_torch.rag.topics import TopicMatcher
from rag_dpo_tpu_torch.retrieval import bm25
from rag_dpo_tpu_torch.retrieval.reranker import CrossEncoderReranker

from test_retrieval import CORPUS

QUESTIONS = (
    "Quel est le délai de notification d'une violation de données ?",
    "Faut-il un registre des traitements ?",
    "Que dit l'article 33 sur la violation de données ?",
    "Quelles obligations en cas de violation ?",
)
FUSED_RTOL = 1e-6
RERANK_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _index(pkg_index, pkg_config, pkg_bm25, embedder, **device):
    texts = [t for _, t, _ in CORPUS]
    metas = []
    for _, text, meta in CORPUS:
        m = dict(meta)
        m["text"] = text
        metas.append(m)
    dense = embedder.embed(texts)["dense"]
    tokens = pkg_bm25.tokenize_corpus(texts)
    stats = pkg_bm25.build_bm25_stats(tokens)
    terms, impacts = pkg_bm25.build_ell_corpus(tokens, stats, ell_width=16)
    index = pkg_index(pkg_config(dim=embedder.dim, ell_width=16,
                                 row_block=8), **device)
    index.add([c for c, _, _ in CORPUS], dense, metas, terms, impacts)
    return index, stats


@pytest.fixture(scope="module")
def both():
    jemb = jproviders.Embedder(jproviders.EmbedderConfig(
        model=JBgeM3Config(encoder=JEncoderConfig.tiny(
            use_flash_attention=False), colbert_dim=32),
        batch_size=8,
    ))
    params = jax.tree.map(np.asarray, jemb.load())
    emb = tproviders.Embedder(tproviders.EmbedderConfig(
        model=BgeM3Config(encoder=EncoderConfig.tiny(), colbert_dim=32),
        batch_size=8,
    ), params=params, device="cpu")
    jindex, jstats = _index(JDeviceIndex, JIndexConfig, jbm25, jemb)
    index, stats = _index(DeviceIndex, IndexConfig, bm25, emb,
                          device="cpu")
    jrr = JCrossEncoderReranker(topic_matcher=JTopicMatcher(jemb))
    rr = CrossEncoderReranker(params=jax.tree.map(np.asarray, jrr.load()),
                              topic_matcher=TopicMatcher(emb), device="cpu")
    return dict(jax=(jindex, jemb, jstats, jrr),
                torch=(index, emb, stats, rr))


def _llm(pkg, kind):
    """The fake of `pkg` (the providers package of either side), or one of
    `tests/test_agent.py`'s scripted variants built on it."""
    fake, response = pkg.FakeLLMProvider, pkg.LLMResponse
    if kind == "refusing":
        class Refusing(fake):
            def generate(self, prompt, **kw):
                if "intention" in prompt.lower() or "intent" in prompt:
                    return response(json.dumps({"intent": "refus"}))
                return super().generate(prompt, **kw)

        return Refusing()
    if kind == "low_coverage":
        class LowCoverage(fake):
            coverage_calls = 0

            def generate(self, prompt, **kw):
                low = prompt.lower()
                if "couverture" in low or "complétude" in low \
                        or "coverage" in prompt:
                    self.coverage_calls += 1
                    if self.coverage_calls == 1:
                        return response(json.dumps({
                            "coverage_pct": 50,
                            "missing_aspects": ["sanctions"],
                            "suggested_queries": ["sanctions violation"],
                        }))
                    return response(json.dumps({"coverage_pct": 95}))
                return super().generate(prompt, **kw)

        return LowCoverage()
    return fake()


def _agents(both, llm="fake", rerank=False, **flags):
    """The two agents over the same corpus. As in `tests/test_agent.py`,
    the refusing provider answers the intent classifier only, and the
    low-coverage one replaces the graph's own provider."""
    out = []
    for side, pkg, create in (("jax", jproviders, j_create_agent),
                              ("torch", tproviders, create_agent_pipeline)):
        index, emb, stats, rr = both[side]
        agent = create(index, emb, pkg.FakeLLMProvider(), bm25_stats=stats,
                       reranker=rr if rerank else None, **flags)
        if llm == "refusing":
            agent.components.intent_classifier.llm = _llm(pkg, llm)
        elif llm != "fake":
            agent.components.llm = _llm(pkg, llm)
        out.append(agent)
    return out


def _same_response(r, jr):
    assert r.answer == jr.answer
    assert r.sources == jr.sources          # titles, urls and chunk ids
    assert (r.intent, r.topics, r.model) == (jr.intent, jr.topics, jr.model)
    assert r.extras == jr.extras            # the node trace among them
    assert (r.n_candidates, r.grounded, r.grounding_issues, r.retried,
            r.error) == (jr.n_candidates, jr.grounded, jr.grounding_issues,
                         jr.retried, jr.error)


@pytest.mark.parametrize("completeness", [True, False])
@pytest.mark.parametrize("refinement", [False, True])
def test_agent_answers_as_jax(both, completeness, refinement):
    jagent, agent = _agents(both, enable_completeness=completeness,
                            enable_expert_refinement=refinement)
    assert isinstance(agent, RAGAgentPipeline)
    for q in QUESTIONS:
        jr, r = jagent.query(q), agent.query(q)
        _same_response(r, jr)
        assert r.answer and r.sources and r.error is None
        trace = r.extras["node_trace"]
        assert "retrieve" in trace and "generate" in trace
        assert ("expert_refinement" in trace) == refinement
        assert ("check_completeness" in trace) == completeness


def test_refusal_route_as_jax(both):
    jagent, agent = _agents(both, llm="refusing")
    for q in ("Quelle est la météo à Paris demain ?",
              "Faut-il un registre des traitements ?"):
        _same_response(agent.query(q), jagent.query(q))
    r = agent.query("Quelle est la météo à Paris demain ?")
    assert r.model == "deterministic_refusal" and r.sources == []
    assert r.extras["refusal_type"] == "hors_perimetre"


def test_re_retrieval_as_jax(both):
    jagent, agent = _agents(both, llm="low_coverage")
    q = "Quelles obligations en cas de violation ?"
    jr, r = jagent.query(q), agent.query(q)
    _same_response(r, jr)
    assert r.extras["node_trace"].count("retrieve") == 2 and r.retried


def test_agent_with_the_cross_encoder_as_jax(both):
    """The shared reranker under the agent: the same reranked sources, and
    per question the same fused candidates and rerank order, scores
    within the stated tolerances."""
    jagent, agent = _agents(both, rerank=True)
    jret, ret = (a.components.retriever for a in (jagent, agent))
    jrr, rr = (a.components.reranker for a in (jagent, agent))
    for q in QUESTIONS:
        _same_response(agent.query(q), jagent.query(q))
        jc = jret.retrieve_candidates(q, n_candidates=40)
        tc = ret.retrieve_candidates(q, n_candidates=40)
        assert [c.row for c in tc] == [c.row for c in jc]
        np.testing.assert_allclose([c.score for c in tc],
                                   [c.score for c in jc], rtol=FUSED_RTOL)
        jranked, ranked = jrr.rerank(q, jc), rr.rerank(q, tc)
        assert [c.row for c in ranked] == [c.row for c in jranked]
        np.testing.assert_allclose([c.rerank_score for c in ranked],
                                   [c.rerank_score for c in jranked],
                                   atol=RERANK_ATOL)


def test_query_stream_ends_in_the_same_response(both):
    jagent, agent = _agents(both)
    q = QUESTIONS[0]
    events = list(agent.query_stream(q))
    assert events[-1][0] == "response"
    assert [kind for kind, _ in events[:-1]] \
        and all(kind == "delta" for kind, _ in events[:-1])
    r = events[-1][1]
    _same_response(r, jagent.query(q))
    assert "".join(d for _, d in events[:-1]).strip()
