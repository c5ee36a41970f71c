"""The port's bootstrap serves the shipped default config (slice 13).

The LLM provider factory and the HTTP provider: `tests/test_http_llm.py`'s
cases run on the port's `HTTPLLMProvider` against that file's stub server
(loopback, no network), and `create_llm` gives each mode's provider.
`HostedAPIProvider` and `create_llm` are held to the JAX package's source.
Then `build_stack(load_config(...))` with every default but the paths and
`llm.base_url`: mode "local" against the port's loopback Ollama-protocol
endpoint (`evals/fake_ollama.py`), the agent on, must answer through the
agent as the fake LLM answers in process; the coalescing knobs wire one
shared reranker into both orchestrators, as `tests/test_bootstrap.py`
checks for the JAX package; `try_build_stack` returns None without an
index.
"""

import ast
import json
import pathlib

import pytest
import torch

import test_http_llm as jhttp
from rag_dpo_tpu_torch.agent import RAGAgentPipeline
from rag_dpo_tpu_torch.bootstrap import build_stack, try_build_stack
from rag_dpo_tpu_torch.evals.fake_ollama import FakeOllama
from rag_dpo_tpu_torch.ingest import CorpusIndexer
from rag_dpo_tpu_torch.providers import (
    Embedder,
    EmbedderConfig,
    FakeLLMProvider,
    HostedAPIProvider,
    HTTPLLMProvider,
    create_llm,
)
from rag_dpo_tpu_torch.utils.config import load_config
from rag_dpo_tpu_torch.utils.paths import default_paths

from test_http_llm import stub  # noqa: F401 — the Ollama-shaped stub
from test_retrieval import CORPUS

REPO = pathlib.Path(__file__).resolve().parent.parent
QUESTION = "Quel est le délai de notification d'une violation de données ?"


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", sorted(
    name for name in vars(jhttp) if name.startswith("test_")))
def test_http_provider_case_on_the_port(case, stub, monkeypatch):  # noqa: F811
    monkeypatch.setattr(jhttp, "HTTPLLMProvider", HTTPLLMProvider)
    getattr(jhttp, case)(stub)


def test_create_llm_modes(stub, monkeypatch):  # noqa: F811
    url, _ = stub
    dead = "http://127.0.0.1:9"
    monkeypatch.delenv("RAGDPO_API_KEY", raising=False)
    local = create_llm("local", base_url=url, model="m")
    assert type(local) is HTTPLLMProvider
    assert (local.base_url, local.model_name) == (url, "m")
    assert type(create_llm("hosted", api_key="k")) is HostedAPIProvider
    assert type(create_llm("hybrid", base_url=dead, api_key="k")) \
        is HostedAPIProvider
    assert type(create_llm("hybrid", base_url=url)) is HTTPLLMProvider
    assert type(create_llm("hybrid", base_url=dead)) is FakeLLMProvider
    assert type(create_llm("fake")) is FakeLLMProvider
    with pytest.raises(NotImplementedError, match="item 7b"):
        create_llm("tpu", arch="tiny")
    with pytest.raises(ValueError, match="unknown llm mode"):
        create_llm("ollama")


def _definitions(path: pathlib.Path) -> dict:
    tree = ast.parse(path.read_text(encoding="utf-8"))
    return {node.name: ast.dump(node) for node in tree.body
            if isinstance(node, (ast.ClassDef, ast.FunctionDef))}


@pytest.mark.parametrize("name", ["HostedAPIProvider", "create_llm"])
def test_factory_definition_equals_jax(name):
    rel = pathlib.Path("providers") / "factory.py"
    assert (_definitions(REPO / "rag_dpo_tpu_torch" / rel)[name]
            == _definitions(REPO / "rag_dpo_tpu" / rel)[name])


@pytest.fixture(scope="module")
def saved_corpus(tmp_path_factory):
    """An index built by the default config's embedder (the tiny BGE-M3
    of seed 0), with document summaries, as `tests/test_bootstrap.py`."""
    paths = default_paths(tmp_path_factory.mktemp("boot")).ensure()
    chunks = []
    for cid, text, meta in CORPUS:
        c = dict(meta)
        c["chunk_id"] = cid
        c["text"] = text
        chunks.append(c)
    embedder = Embedder(EmbedderConfig(), device="cpu")
    index, _, _ = CorpusIndexer(embedder, ell_width=16).build(chunks)
    index.save(paths.index_dir)
    paths.document_summaries.write_text(json.dumps({
        m["doc_key"]: {"title": m["title"], "summary": t,
                       "url": m["source_url"], "navigation": False}
        for _, t, m in CORPUS
    }))
    return paths, embedder


def test_default_config_serves_through_the_agent(saved_corpus):
    paths, _ = saved_corpus
    with FakeOllama() as ollama:
        cfg = load_config(env={"RAGDPO_LLM_BASE_URL": ollama.url})
        assert cfg.llm.mode == "local" and cfg.agent.enable
        assert cfg.retrieval.use_reranker and cfg.retrieval.hybrid
        stack = build_stack(cfg, paths, device="cpu")
        assert type(stack.llm) is HTTPLLMProvider
        assert stack.active() is stack.agent
        assert isinstance(stack.agent, RAGAgentPipeline)
        assert stack.active(use_agent=False) is stack.pipeline
        assert stack.agent.graph.c.reranker is stack.pipeline.reranker
        resp = stack.active().query(QUESTION)
        assert "/api/chat" in ollama.paths and "/api/generate" in ollama.paths
    assert resp.answer and resp.sources and resp.error is None
    assert "generate" in resp.extras["node_trace"]
    # the HTTP round trip changes nothing: the fake in process answers the same
    direct = build_stack(cfg, paths, llm=FakeLLMProvider(),
                         embedder=stack.embedder, device="cpu")
    same = direct.agent.query(QUESTION)
    assert (same.answer, same.sources, same.extras) \
        == (resp.answer, resp.sources, resp.extras)


def test_coalescing_knobs_wire_through_bootstrap(saved_corpus):
    paths, _ = saved_corpus
    cfg = load_config(env={"RAGDPO_LLM_MODE": "fake",
                           "RAGDPO_RETRIEVAL_RERANK_BATCH": "8",
                           "RAGDPO_EMBEDDING_QUERY_BATCH": "8"})
    stack = build_stack(cfg, paths, device="cpu")
    rr = stack.pipeline.reranker
    assert rr._pair_batcher is not None and rr._pair_batcher.max_batch == 8
    assert stack.agent.graph.c.reranker is rr
    assert stack.embedder._query_batcher.max_batch == 8
    resp = stack.active().query(QUESTION)
    assert resp.answer and resp.sources and resp.error is None
    assert rr._pair_batcher.stats.n_requests >= 1
    assert stack.embedder._query_batcher.stats.n_requests >= 1
    # the query batch applies to an injected embedder too
    injected = Embedder(EmbedderConfig(), device="cpu")
    build_stack(cfg, paths, embedder=injected, device="cpu")
    assert injected._query_batcher.max_batch == 8
    for batcher in (rr._pair_batcher, stack.embedder._query_batcher,
                    injected._query_batcher):
        batcher.close()


def test_decoder_mode_still_raises(saved_corpus):
    paths, _ = saved_corpus
    with pytest.raises(NotImplementedError, match="item 7b"):
        build_stack(load_config(env={"RAGDPO_LLM_MODE": "tpu"}), paths,
                    device="cpu")


def test_try_build_stack(saved_corpus, tmp_path, monkeypatch):
    assert try_build_stack(default_paths(tmp_path), device="cpu") is None
    paths, _ = saved_corpus
    monkeypatch.setenv("RAGDPO_LLM_MODE", "fake")
    stack = try_build_stack(paths, device="cpu")
    assert type(stack.llm) is FakeLLMProvider
    assert stack.active() is stack.agent
    assert stack.agent.query(QUESTION).answer
