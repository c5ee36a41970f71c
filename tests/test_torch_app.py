"""The port's HTTP server against the JAX package's (slice 15).

Both packages' `app.server.build_system` boot the same saved index (the
demo corpus, encoded by the JAX tiny encoder and saved once) through their
bootstrap, with the encoder and cross-encoder weights carried across (the
Flax trees as numpy, as `models/convert.py` loads them) and the fake LLM;
`serve(port=0, ...)` serves each on loopback. The requests of
`tests/test_server.py` that need no on-card decoder go to both: status
codes and ids must be equal, scores and vectors within 1e-5 (f32 encoders
of two frameworks, ~1e-6 apart), and the timing fields and per-request
ids (`timings`, `query_id`, `created`, `id`) are left out. The decoder's
options (logprobs, `logit_bias`, `seed`, penalties) are refused or ignored
by the fake provider in both in the same JSON. The JAX side runs
attention in reference mode; the port runs its flash kernel's plain twin.
"""

import base64
import json
import shutil
import struct
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import rag_dpo_tpu.bootstrap as jbootstrap
import rag_dpo_tpu.providers as jproviders
import rag_dpo_tpu_torch.bootstrap as tbootstrap
import rag_dpo_tpu_torch.providers as tproviders
from rag_dpo_tpu.app import server as jserver
from rag_dpo_tpu.app.demo import DEMO_CORPUS
from rag_dpo_tpu.ingest.indexer import CorpusIndexer as JCorpusIndexer
from rag_dpo_tpu.models import BgeM3Config as JBgeM3Config
from rag_dpo_tpu.models import EncoderConfig as JEncoderConfig
from rag_dpo_tpu.rag.topics import TopicMatcher as JTopicMatcher
from rag_dpo_tpu.retrieval.reranker import (
    CrossEncoderReranker as JCrossEncoderReranker,
)
from rag_dpo_tpu_torch.app import server as tserver
from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
from rag_dpo_tpu_torch.rag.topics import TopicMatcher
from rag_dpo_tpu_torch.retrieval.reranker import CrossEncoderReranker

ATOL = 1e-5
VOLATILE = {"timings", "query_id", "created", "id", "total_time"}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _demo_chunks():
    return [{"chunk_id": cid, "text": body, "title": title,
             "heading": heading, "source_url": url,
             "doc_key": url.split("//")[1], "source": "CNIL",
             "nature": "DOCTRINE"}
            for cid, title, url, heading, body in DEMO_CORPUS]


def _boot(pkg_server, pkg_bootstrap, root, monkeypatch, embedder,
          reranker, llm, **device):
    """`pkg_server.build_system` over the index saved under `root`, with
    the encoders injected into the bootstrap it calls."""
    orig = pkg_bootstrap.build_stack

    def injected(config=None, paths=None, llm=None, **kw):
        return orig(config, paths, llm=llm, embedder=embedder,
                    reranker=reranker, **kw)

    with monkeypatch.context() as m:
        m.setenv("RAGDPO_TPU_ROOT", str(root))
        m.setattr(pkg_bootstrap, "build_stack", injected)
        return pkg_server.build_system(agent_too=False, llm=llm, **device)


def _serve(pkg_server, system):
    srv = pkg_server.serve(port=0, system=system)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    jemb = jproviders.Embedder(jproviders.EmbedderConfig(
        model=JBgeM3Config(encoder=JEncoderConfig.tiny(
            use_flash_attention=False), colbert_dim=32),
        batch_size=8))
    emb = tproviders.Embedder(tproviders.EmbedderConfig(
        model=BgeM3Config(encoder=EncoderConfig.tiny(), colbert_dim=32),
        batch_size=8), params=jax.tree.map(np.asarray, jemb.load()),
        device="cpu")
    jrr = JCrossEncoderReranker(topic_matcher=JTopicMatcher(jemb))
    rr = CrossEncoderReranker(params=jax.tree.map(np.asarray, jrr.load()),
                              topic_matcher=TopicMatcher(emb), device="cpu")
    jroot = tmp_path_factory.mktemp("jax_srv")
    troot = tmp_path_factory.mktemp("port_srv")
    index, _, _ = JCorpusIndexer(jemb, ell_width=24).build(_demo_chunks())
    index.save(jroot / "data" / "index")
    shutil.copytree(jroot / "data" / "index", troot / "data" / "index")
    mp = pytest.MonkeyPatch()
    jsys = _boot(jserver, jbootstrap, jroot, mp, jemb, jrr,
                 jproviders.FakeLLMProvider())
    tsys = _boot(tserver, tbootstrap, troot, mp, emb, rr,
                 tproviders.FakeLLMProvider(), device="cpu")
    jsrv, jurl = _serve(jserver, jsys)
    tsrv, turl = _serve(tserver, tsys)
    yield dict(jax=jurl, torch=turl, jsys=jsys, tsys=tsys)
    jsrv.shutdown()
    tsrv.shutdown()
    for system in (jsys, tsys):
        system["search"].batcher.close()


def _request(url, path, payload=None, raw=None, headers=None):
    """(status, body bytes, content type) of one request; GET without a
    payload."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url + path, data=data, headers=headers or {
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def _json(url, path, payload=None, **kw):
    code, body, _ = _request(url, path, payload, **kw)
    return code, json.loads(body)


def assert_same(a, b, where="$"):
    """Equal JSON trees but for VOLATILE keys; floats within ATOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, a, b)
        for k in a:
            if k not in VOLATILE:
                assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= ATOL, (where, a, b)
    else:
        assert a == b, (where, a, b)


def both_json(twins, path, payload=None, **kw):
    """The same request to both servers; equal status and JSON."""
    jcode, jdata = _json(twins["jax"], path, payload, **kw)
    code, data = _json(twins["torch"], path, payload, **kw)
    assert code == jcode, (path, payload, jcode, code, jdata, data)
    assert_same(jdata, data)
    return code, data


def test_healthz(twins):
    jcode, jdata = _json(twins["jax"], "/healthz")
    code, data = _json(twins["torch"], "/healthz")
    assert code == jcode == 200
    assert data["status"] == jdata["status"] == "ok"
    assert data["n_chunks"] == jdata["n_chunks"] == len(DEMO_CORPUS)
    names = [torch.cuda.get_device_name(i)
             for i in range(torch.cuda.device_count())]
    assert data["devices"] == (names or ["cpu"])


def test_build_system_takes_the_bootstrap(twins):
    """A saved index routes `build_system` through `try_build_stack`, on
    the device asked for."""
    for key in ("jsys", "tsys"):
        system = twins[key]
        assert system["index"].n_rows == len(DEMO_CORPUS)
        assert type(system["llm"]).__name__ == "FakeLLMProvider"
        assert system["agent_pipe"] is system["pipe"]
    assert twins["tsys"]["index"].device.type == "cpu"
    assert twins["tsys"]["embedder"].device.type == "cpu"


def test_query_and_feedback_flow(twins):
    code, data = both_json(twins, "/query", {
        "question": "Quel délai pour notifier une violation à la CNIL ?"})
    assert code == 200 and data["answer"] and data["sources"]
    assert data["timings"]["total"] > 0
    for key in ("jax", "torch"):
        qid = _json(twins[key], "/query", {
            "question": "Quel registre tenir ?"})[1]["query_id"]
        code, fb = _json(twins[key], "/feedback",
                         {"query_id": qid, "rating": 1})
        assert code == 200 and fb["ok"]
    jstats = _json(twins["jax"], "/stats")[1]
    stats = _json(twins["torch"], "/stats")[1]
    assert stats["n_queries"] == jstats["n_queries"] >= 2
    assert stats["satisfaction"] == jstats["satisfaction"]


def test_streamed_query_matches(twins):
    """`"stream": true`: the same delta events, then the same response."""
    events = {}
    for key in ("jax", "torch"):
        code, body, ctype = _request(twins[key], "/query", {
            "question": "Quand faire une AIPD ?", "stream": True})
        assert code == 200 and ctype.startswith("text/event-stream")
        events[key] = [json.loads(line[6:]) for line in
                       body.decode().splitlines()
                       if line.startswith("data: ")
                       and line != "data: [DONE]"]
    assert events["torch"] and "response" in events["torch"][-1]
    assert_same(events["jax"], events["torch"])


def test_metrics_prometheus_format(twins):
    names = {}
    for key in ("jax", "torch"):
        _json(twins[key], "/query", {"question": "Quel registre tenir ?"})
        code, body, ctype = _request(twins[key], "/metrics")
        assert code == 200 and ctype.startswith("text/plain")
        lines = [ln.partition(" ") for ln in body.decode().splitlines()
                 if ln]
        for name, _, value in lines:
            assert name.startswith("ragdpo_")
            float(value)
        names[key] = {name: value for name, _, value in lines}
    assert set(names["torch"]) == set(names["jax"])
    assert names["torch"]["ragdpo_n_queries"] == \
        names["jax"]["ragdpo_n_queries"]


@pytest.mark.parametrize("path,payload", [
    ("/query", {}),
    ("/feedback", {"rating": 1}),
    ("/feedback", {"query_id": "x", "rating": "bien"}),
    ("/search", {}),
    ("/search", {"vectors": [1, 2, 3]}),
    ("/search", {"texts": ["délai violation"], "k": "beaucoup"}),
    ("/query", {"question": "q", "n_documents": "douze"}),
    ("/choose", {"prompt": "x", "choices": ["a", "b"]}),
    ("/nope", {}),
])
def test_validation_and_errors_match(twins, path, payload):
    code, _ = both_json(twins, path, payload)
    assert code >= 400


def test_unknown_route_and_bad_json(twins):
    for key in ("jax", "torch"):
        code, _, _ = _request(twins[key], "/nope")
        assert code == 404
        code, _, _ = _request(twins[key], "/query", raw=b"not json")
        assert code == 400


def test_models_listing(twins):
    code, data = both_json(twins, "/v1/models")
    assert code == 200 and data["data"][0]["id"]


def test_search_by_texts_and_vectors(twins):
    code, data = both_json(twins, "/search", {
        "texts": ["délai de notification violation"], "k": 3})
    assert code == 200 and len(data["results"][0]) == 3
    vecs = twins["tsys"]["embedder"].embed_queries(
        ["registre des traitements", "sanctions"])
    code, data = both_json(twins, "/search", {
        "vectors": vecs.tolist(), "k": 4, "where": None})
    assert code == 200 and [len(r) for r in data["results"]] == [4, 4]
    code, data = both_json(twins, "/search", {
        "vectors": vecs.tolist(), "k": 4, "where": {"nature": "GUIDE"}})
    assert code == 200


def test_bad_k_clamps_and_oversized_batch_splits(twins):
    code, data = both_json(twins, "/search", {
        "texts": ["délai violation"], "k": 99999})
    assert code == 200 and data["results"]
    code, data = both_json(twins, "/search", {
        "texts": ["notification violation"] * 3, "k": 2})
    assert code == 200 and len(data["results"]) == 3


def test_search_concurrent_batches(twins):
    texts = ["durée de conservation", "sous-traitant", "AIPD",
             "droit d'accès", "registre", "sanction CNIL"]
    results = {}
    for key in ("jax", "torch"):
        out = {}

        def call(text, url=twins[key]):
            out[text] = _json(url, "/search", {"texts": [text], "k": 2})

        threads = [threading.Thread(target=call, args=(t,)) for t in texts]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results[key] = out
        stats = _json(twins[key], "/stats")[1]
        assert stats["search_batcher"]["n_requests"] >= len(texts)
    for text in texts:
        assert results["torch"][text][0] == results["jax"][text][0] == 200
        assert_same(results["jax"][text][1], results["torch"][text][1])


def test_concurrent_queries_with_semaphore(twins):
    questions = [f"Quel délai de notification ? v{i}" for i in range(3)]
    answers = {}
    for key, pkg, system in (("jax", jserver, twins["jsys"]),
                             ("torch", tserver, twins["tsys"])):
        srv, url = _serve(pkg, dict(system, max_concurrent_queries=4))
        out = {}
        threads = [threading.Thread(target=lambda q=q, u=url: out.update(
            {q: _json(u, "/query", {"question": q})})) for q in questions]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        srv.shutdown()
        answers[key] = out
    for q in questions:
        assert answers["torch"][q][0] == answers["jax"][q][0] == 200
        assert_same(answers["jax"][q][1], answers["torch"][q][1])


def test_binary_search_roundtrip(twins):
    rng = np.random.default_rng(0)
    q, dim, k = 2, twins["tsys"]["index"].config.dim, 4
    vecs = rng.standard_normal((q, dim)).astype(np.float32)
    body = b"RDPV" + struct.pack("<III", q, dim, k) + vecs.tobytes()
    for where in (None, '{"nature": "GUIDE"}'):
        headers = {"Content-Type": "application/octet-stream"}
        if where:
            headers["X-Where"] = where
        outs = [_request(twins[key], "/search", raw=body, headers=headers)
                for key in ("jax", "torch")]
        for code, out, _ in outs:
            assert code == 200 and out[:4] == b"RDPR"
            assert struct.unpack("<II", out[4:12]) == (q, k)
        (_, jout, _), (_, out, _) = outs
        off = 12 + q * k * 4
        np.testing.assert_array_equal(
            np.frombuffer(out, np.int32, q * k, off),
            np.frombuffer(jout, np.int32, q * k, off))
        np.testing.assert_allclose(np.frombuffer(out, np.float32, q * k, 12),
                                   np.frombuffer(jout, np.float32, q * k, 12),
                                   atol=ATOL)
    for raw in (b"XXXX....", b"RDPV" + struct.pack("<III", q, dim + 1, k)
                + vecs.tobytes()):
        jcode, jbody, _ = _request(twins["jax"], "/search", raw=raw,
                                   headers={"Content-Type":
                                            "application/octet-stream"})
        code, tbody, _ = _request(twins["torch"], "/search", raw=raw,
                                  headers={"Content-Type":
                                           "application/octet-stream"})
        assert code == jcode == 400 and tbody == jbody


def test_openai_embeddings(twins):
    emb = twins["tsys"]["embedder"]
    code, data = both_json(twins, "/v1/embeddings",
                           {"input": "Qu'est-ce qu'une AIPD ?"})
    assert code == 200 and data["usage"]["prompt_tokens"] > 0
    np.testing.assert_allclose(
        np.asarray(data["data"][0]["embedding"], np.float32),
        emb.embed_queries(["Qu'est-ce qu'une AIPD ?"])[0], atol=ATOL)
    texts = ["registre des traitements", "durée de conservation"]
    vecs = {}
    for key in ("jax", "torch"):
        code, data = _json(twins[key], "/v1/embeddings",
                           {"input": texts, "encoding_format": "base64"})
        assert code == 200 and [d["index"] for d in data["data"]] == [0, 1]
        vecs[key] = np.stack([np.frombuffer(base64.b64decode(
            d["embedding"]), np.float32) for d in data["data"]])
    np.testing.assert_allclose(vecs["torch"], vecs["jax"], atol=ATOL)
    np.testing.assert_allclose(vecs["torch"], emb.embed_queries(texts),
                               atol=ATOL)
    code, data = both_json(twins, "/v1/embeddings",
                           {"input": texts, "input_type": "document"})
    assert code == 200
    np.testing.assert_allclose(
        np.asarray(data["data"][1]["embedding"], np.float32),
        emb.embed(texts)["dense"][1], atol=ATOL)
    for body in ({}, {"input": []}, {"input": [1, 2]},
                 {"input": ["a"] * 257},
                 {"input": "x", "encoding_format": "int8"},
                 {"input": "x", "dimensions": 64},
                 {"input": "x", "input_type": "passage"}):
        code, _ = both_json(twins, "/v1/embeddings", body)
        assert code == 400
    codes = []
    for key, pkg in (("jsys", jserver), ("tsys", tserver)):
        system = dict(twins[key])
        system.pop("embedder")
        system.pop("search")
        srv, url = _serve(pkg, system)
        codes.append(_json(url, "/v1/embeddings", {"input": "x"}))
        srv.shutdown()
    assert codes[0] == codes[1] and codes[1][0] == 503, codes


MSGS = [{"role": "system", "content": "Assistant RGPD."},
        {"role": "user", "content": "registre des traitements"}]


@pytest.mark.parametrize("path,payload", [
    ("/v1/chat/completions", {"messages": MSGS, "max_tokens": 12}),
    ("/v1/chat/completions", {"messages": MSGS, "n": 2}),
    ("/v1/chat/completions", {"messages": []}),
    ("/v1/chat/completions", {"messages": [{"role": "user"}]}),
    ("/v1/chat/completions", {"messages": MSGS, "temperature": "chaud"}),
    ("/v1/chat/completions", {"messages": MSGS, "n": 9}),
    ("/v1/completions", {"prompt": "La CNIL est", "max_tokens": 8}),
    ("/v1/completions", {"prompt": ["La CNIL est", "Le RGPD impose"]}),
    ("/v1/completions", {}),
    ("/v1/completions", {"prompt": ["a"] * 9}),
    ("/v1/completions", {"prompt": "x", "temperature": "hot"}),
    ("/generate", {"prompt": "Bonjour", "max_tokens": 8}),
])
def test_openai_and_generate_with_the_fake_llm(twins, path, payload):
    both_json(twins, path, payload)


@pytest.mark.parametrize("path,extra", [
    ("/v1/chat/completions", {"logprobs": True}),
    ("/v1/chat/completions", {"logprobs": True, "top_logprobs": 3}),
    ("/v1/chat/completions", {"logprobs": True, "top_logprobs": 9}),
    ("/v1/chat/completions", {"top_logprobs": 2}),
    ("/v1/chat/completions", {"logit_bias": {"5": 2.0}}),
    ("/v1/chat/completions", {"logit_bias": {"x": 2.0}}),
    ("/v1/chat/completions", {"seed": 11, "temperature": 0.9}),
    ("/v1/chat/completions", {"presence_penalty": 0.5}),
    ("/v1/chat/completions", {"frequency_penalty": 3.0}),
    ("/v1/completions", {"logprobs": 2}),
    ("/v1/completions", {"seed": 3}),
    ("/generate", {"frequency_penalty": 0.5}),
])
def test_decoder_options_answer_as_jax(twins, path, extra):
    """The decoder's options with the fake provider behind the routes: the
    same status and JSON in both packages (`test_pool_routes_answer_as_jax`
    sends them to the continuous decoder)."""
    base = ({"messages": MSGS} if path == "/v1/chat/completions"
            else {"prompt": "La CNIL est"})
    both_json(twins, path, dict(base, max_tokens=8, **extra))


@pytest.fixture(scope="module")
def pool_twins(twins):
    """Both servers again, their generation on the continuous scheduler:
    the JAX provider and the port's over the same JAX-exported f32 tiny
    decoder, two slots each."""
    from rag_dpo_tpu.models.decoder import DecoderConfig as JDecoderConfig
    from rag_dpo_tpu.providers.tpu_llm import TPULLMProvider as JTPULLM
    from rag_dpo_tpu_torch.providers.tpu_llm import TPULLMProvider
    from test_torch_decoder import jax_params, port_config

    jcfg = JDecoderConfig.tiny(num_heads=4, num_kv_heads=2,
                               dtype=jax.numpy.float32)
    params = jax_params(jcfg, seed=4)
    jllm = JTPULLM(jcfg, params=jax.tree.map(jax.numpy.asarray, params),
                   max_new_tokens=8, continuous=True, max_batch=2)
    tllm = TPULLMProvider(port_config(jcfg), params=params,
                          max_new_tokens=8, continuous=True, max_batch=2,
                          device="cpu")
    servers, urls = [], {}
    for key, pkg, llm in (("jax", jserver, jllm), ("torch", tserver, tllm)):
        system = dict(twins["jsys" if key == "jax" else "tsys"],
                      llm=llm, stream_llm=llm)
        srv, urls[key] = _serve(pkg, system)
        servers.append(srv)
    yield dict(urls, jllm=jllm, tllm=tllm)
    for srv in servers:
        srv.shutdown()
    for llm in (jllm, tllm):
        llm._driver.close()


@pytest.mark.parametrize("path,extra", [
    ("/v1/chat/completions", {}),
    ("/v1/chat/completions", {"logprobs": True}),
    ("/v1/chat/completions", {"logprobs": True, "top_logprobs": 3}),
    ("/v1/chat/completions", {"logprobs": True, "top_logprobs": 9}),
    ("/v1/chat/completions", {"logprobs": True, "stream": True}),
    ("/v1/chat/completions", {"logit_bias": {"5": 100}}),
    ("/v1/chat/completions", {"logit_bias": {"999999": 1}}),
    ("/v1/chat/completions", {"presence_penalty": 0.5,
                              "frequency_penalty": 0.5}),
    ("/v1/chat/completions", {"n": 2}),
    ("/v1/completions", {"logit_bias": {"7": -100}}),
    ("/generate", {}),
    ("/generate", {"logprobs": 5, "logit_bias": {"9": 4.0}}),
    ("/generate", {"frequency_penalty": 0.5, "presence_penalty": 1.0}),
    ("/generate", {"timeout_s": 0}),
    ("/generate", {"timeout_s": 60}),
    ("/generate", {"priority": 1}),
])
def test_pool_routes_answer_as_jax(pool_twins, path, extra):
    """With the continuous provider: the same status and JSON from both
    servers (greedy, so the same tokens; logprobs within ATOL)."""
    base = ({"messages": MSGS} if path == "/v1/chat/completions"
            else {"prompt": "La CNIL est"})
    both_json(pool_twins, path, dict(base, max_tokens=8, **extra))


def test_pool_seeded_sampling_answers_in_the_same_shape(pool_twins):
    """A seeded sampled request: the same keys and status from both (the
    draws are JAX's keys since C-28 closed; the text is not compared, as
    a near-tie may pick another token, C-29), and the port's answer
    reproduces from its seed, as JAX's does."""
    payload = {"prompt": "La CNIL est", "max_tokens": 8, "seed": 11,
               "temperature": 0.9}
    jcode, jdata = _json(pool_twins["jax"], "/generate", payload)
    code, data = _json(pool_twins["torch"], "/generate", payload)
    assert code == jcode == 200 and set(data) == set(jdata)
    for url, first in ((pool_twins["jax"], jdata), (pool_twins["torch"],
                                                    data)):
        assert _json(url, "/generate", payload)[1]["text"] == first["text"]


# the port's counters of the pool's time (`serving/continuous.py`)
POOL_TIMING = ("queue_wait_ns", "prefills", "prefill_rows", "prefill_tokens",
               "prefill_device_ns", "decode_device_ns")


def test_pool_stats_and_metrics_answer_as_jax(pool_twins):
    """/stats' decode_pool block and /metrics' pool lines after the same
    requests: equal keys and equal counters, and the port's own counters
    of the pool's time (`POOL_TIMING`) besides."""
    for url in (pool_twins["jax"], pool_twins["torch"]):
        _json(url, "/generate", {"prompt": "registre", "max_tokens": 4})
    _, jstats = _json(pool_twins["jax"], "/stats")
    _, stats = _json(pool_twins["torch"], "/stats")
    jpool, pool = jstats["decode_pool"], stats["decode_pool"]
    assert set(pool) == set(jpool) | set(POOL_TIMING)
    assert pool["prefills"] == pool["admitted"] and pool["queue_wait_ns"] > 0
    assert 0 < pool["prefill_tokens"] <= pool["prefill_rows"]
    assert pool["prefill_device_ns"] > 0 and pool["decode_device_ns"] > 0
    for key in ("slots", "prefix_cache", "speculative", "admitted",
                "cancelled", "preempted", "timeouts"):
        assert pool[key] == jpool[key], (key, pool, jpool)
    assert pool["admitted"] >= 1
    jlines = _request(pool_twins["jax"], "/metrics")[1].decode()
    lines = _request(pool_twins["torch"], "/metrics")[1].decode()
    names = {ln.split()[0].split("{")[0] for ln in lines.splitlines()
             if ln.startswith("ragdpo_decode_pool")}
    assert names and names == {
        ln.split()[0].split("{")[0] for ln in jlines.splitlines()
        if ln.startswith("ragdpo_decode_pool")} | {
        f"ragdpo_decode_pool_{key}" for key in POOL_TIMING}


def test_pool_stream_close_cancels_on_both(pool_twins):
    """A `/generate` stream the client drops mid-flight: the pool cancels
    the request in both packages."""
    for key, llm in (("jax", pool_twins["jllm"]),
                     ("torch", pool_twins["tllm"])):
        engine = llm._driver.engine
        before = engine.stats["cancelled"]
        orig = engine.step
        engine.step = lambda: (time.sleep(0.05), orig())[1]
        try:
            req = urllib.request.Request(
                pool_twins[key] + "/generate",
                data=json.dumps({"prompt": "La CNIL est", "stream": True,
                                 "max_tokens": 64}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                r.readline()
            deadline = time.time() + 30
            while engine.stats["cancelled"] == before \
                    and time.time() < deadline:
                time.sleep(0.02)
        finally:
            engine.step = orig
        assert engine.stats["cancelled"] == before + 1, key


def test_logprob_topk_is_the_decoders():
    """The server's top_logprobs bound is the port decoder's constant,
    imported where the JAX server imports its own, and the two agree."""
    import inspect

    from rag_dpo_tpu.models.generate import LOGPROB_TOPK
    from rag_dpo_tpu_torch.models import generate

    assert generate.LOGPROB_TOPK == LOGPROB_TOPK
    assert not hasattr(tserver, "LOGPROB_TOPK")
    assert "from ..models.generate import LOGPROB_TOPK" \
        in inspect.getsource(tserver)


def test_warm_coalesced_runs_the_batchers(twins):
    """`--warm`'s `_warm_coalesced` drives coalesced encodes and a
    coalesced rerank through the batchers, in both packages (batching is
    switched off again afterwards)."""
    for key, pkg in (("jsys", jserver), ("tsys", tserver)):
        system = twins[key]
        emb, rr = system["embedder"], system["pipe"].reranker
        emb.enable_query_batching(max_batch=16)
        rr.enable_pair_batching(max_batch=16)
        try:
            pkg._warm_coalesced(system)
            assert emb._query_batcher.stats.n_device_calls >= 1
            assert rr._pair_batcher.stats.n_device_calls >= 1
        finally:
            for owner, attr in ((emb, "_query_batcher"),
                                (rr, "_pair_batcher")):
                getattr(owner, attr).close()
                setattr(owner, attr, None)
