"""Slice 1 end to end: the port against the JAX package on the hermetic
synthetic corpus, and the port alone with jax refused at import (the query
path, slice 2's train step, checkpoint and npz export, slice 3's MaxSim
rerank and hermetic replay module, slice 4's int8 and postings searches,
slice 14's corpus-build modules, with bs4 and lxml refused too, as the
card's machine has neither, slice 15's HF conversion and demo server,
with transformers and safetensors refused, slice 18's image request
through a tiny `attach_vision` on the continuous pool, slice 19's mesh
modules: a gloo world of one through a row-sharded store, and slice 20's
sharded train step on it).

Both stacks use the same exported Flax parameters (tiny encoder in
reference-attention mode and ELL width 48, as `evals/hermetic.py` builds
them), so the per-question fused candidate ids must be identical — the
aggregate metrics of the replay could hide a two-question drift.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from rag_dpo_tpu import native
from rag_dpo_tpu.evals.synthetic import ExtractiveFakeLLM as JExtractiveLLM
from rag_dpo_tpu.evals.synthetic import build_synthetic_corpus
from rag_dpo_tpu.ingest.indexer import CorpusIndexer as JCorpusIndexer
from rag_dpo_tpu.models import BgeM3Config as JBgeM3Config
from rag_dpo_tpu.models import EncoderConfig as JEncoderConfig
from rag_dpo_tpu.models.convert import load_params_npz
from rag_dpo_tpu.providers import Embedder as JEmbedder
from rag_dpo_tpu.providers import EmbedderConfig as JEmbedderConfig
from rag_dpo_tpu.rag import create_pipeline as j_create_pipeline
from rag_dpo_tpu.rag.topics import TopicMatcher as JTopicMatcher
from rag_dpo_tpu.retrieval import HybridRetriever as JHybridRetriever
from rag_dpo_tpu.retrieval.reranker import (
    CrossEncoderReranker as JCrossEncoderReranker,
)
from rag_dpo_tpu_torch import native as tnative
from rag_dpo_tpu_torch.evals.synthetic import ExtractiveFakeLLM
from rag_dpo_tpu_torch.ingest import CorpusIndexer
from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
from rag_dpo_tpu_torch.providers import Embedder, EmbedderConfig
from rag_dpo_tpu_torch.rag import create_pipeline
from rag_dpo_tpu_torch.rag.topics import TopicMatcher
from rag_dpo_tpu_torch.retrieval import HybridRetriever
from rag_dpo_tpu_torch.retrieval.reranker import CrossEncoderReranker

REPO = pathlib.Path(__file__).resolve().parent.parent
DATASET = REPO / "rag_dpo_tpu" / "evals" / "data" / "qa_dataset.json"
TRAINED = REPO / "rag_dpo_tpu" / "evals" / "data" / "trained_encoder_v2.npz"


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: each pytest-xdist worker would otherwise start
    one per core, and oversubscribed, torch's CPU ops run ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module", params=["random-init", "trained"])
def stacks(request):
    dataset = json.loads(DATASET.read_text())
    chunks = build_synthetic_corpus(dataset)
    tree = None if request.param == "random-init" else load_params_npz(TRAINED)
    jemb = JEmbedder(JEmbedderConfig(model=JBgeM3Config(
        encoder=JEncoderConfig.tiny(use_flash_attention=False),
        colbert_dim=32)), params=tree)
    emb = Embedder(EmbedderConfig(model=BgeM3Config(
        encoder=EncoderConfig.tiny(use_flash_attention=False),
        colbert_dim=32)), params=_numpy_tree(jemb.load()), device="cpu")
    # BM25 impacts from the Python path on both sides: the C++ runtime
    # rounds them from double and differs in the last ulp on some rows
    # (ROADMAP C-8; tests/test_torch_native.py holds the two packages'
    # native builds to each other)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "is_available", lambda: False)
        mp.setattr(tnative, "is_available", lambda: False)
        jindex, jstats, _ = JCorpusIndexer(jemb, ell_width=48).build(chunks)
        index, stats, _ = CorpusIndexer(emb, ell_width=48).build(chunks)
    return dict(kind=request.param, dataset=dataset, jemb=jemb, emb=emb,
                jindex=jindex, jstats=jstats, index=index, stats=stats)


def test_indexes_agree(stacks):
    j, t = stacks["jindex"], stacks["index"]
    assert t.ids == j.ids
    assert t.bm25_stats.vocab == j.bm25_stats.vocab
    np.testing.assert_array_equal(t._terms, j._terms)
    np.testing.assert_array_equal(t._impacts, j._impacts)
    # f16 host rows of unit vectors: within one f16 rounding step
    np.testing.assert_allclose(t._dense.astype(np.float32),
                               j._dense.astype(np.float32), atol=1e-3)


def test_fused_candidate_ids_identical_for_all_48_questions(stacks):
    jret = JHybridRetriever(stacks["jindex"], stacks["jemb"],
                            bm25_stats=stacks["jstats"])
    ret = HybridRetriever(stacks["index"], stacks["emb"],
                          bm25_stats=stacks["stats"])
    assert len(stacks["dataset"]) == 48
    score_drift = []
    for item in stacks["dataset"]:
        q = item["question"]
        jc = jret.retrieve_candidates(q, n_candidates=40)
        tc = ret.retrieve_candidates(q, n_candidates=40)
        assert [c.row for c in tc] == [c.row for c in jc], q
        if not np.allclose([c.score for c in tc], [c.score for c in jc],
                           rtol=1e-6, atol=0):
            score_drift.append(q)
    # Fused scores are RRF sums of arm ranks. The random-init encoder
    # maps every chunk within cosine 0.996 of every query, and on one
    # question two dense scores sit 6e-7 apart: the f32 encoders of the
    # two frameworks (~1e-6 apart) swap dense ranks 1 and 2 there, which
    # moves two fused scores but not the fused order. The trained
    # encoder has no such near-tie.
    assert len(score_drift) <= (1 if stacks["kind"] == "random-init" else 0)


def test_pipeline_answers_and_sources_match(stacks):
    jrr = JCrossEncoderReranker(topic_matcher=JTopicMatcher(stacks["jemb"]))
    rr = CrossEncoderReranker(params=_numpy_tree(jrr.load()), device="cpu",
                              topic_matcher=TopicMatcher(stacks["emb"]))
    jpipe = j_create_pipeline(stacks["jindex"], stacks["jemb"],
                              JExtractiveLLM(), bm25_stats=stacks["jstats"],
                              reranker=jrr)
    pipe = create_pipeline(stacks["index"], stacks["emb"],
                           ExtractiveFakeLLM(), bm25_stats=stacks["stats"],
                           reranker=rr)
    for item in stacks["dataset"][:4]:
        jr = jpipe.query(item["question"])
        r = pipe.query(item["question"])
        assert r.answer == jr.answer
        assert r.sources == jr.sources
        assert r.sources and r.error is None


BLOCKED_RUN = textwrap.dedent("""
    import importlib.abc, json, pathlib, sys, tempfile

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "orbax",
                       "transformers", "safetensors", "rag_dpo_tpu", "bs4",
                       "lxml"):
                raise ImportError(f"refused: {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    from rag_dpo_tpu_torch.bootstrap import build_stack
    from rag_dpo_tpu_torch.evals.synthetic import (
        ExtractiveFakeLLM, build_synthetic_corpus)
    from rag_dpo_tpu_torch.evals.train_encoder import build_training_pairs
    from rag_dpo_tpu_torch.ingest import CorpusIndexer
    from rag_dpo_tpu_torch.models import BgeM3Config
    from rag_dpo_tpu_torch.models.convert import (
        load_params_npz, save_params_npz, state_dict_to_flax)
    from rag_dpo_tpu_torch.providers import Embedder, EmbedderConfig
    from rag_dpo_tpu_torch.retrieval.reranker import CrossEncoderReranker
    from rag_dpo_tpu_torch.train import (
        TrainConfig, create_train_state, make_train_step)
    from rag_dpo_tpu_torch.train.checkpoint import TrainCheckpointer
    from rag_dpo_tpu_torch.train.loop import PairBatcher
    from rag_dpo_tpu_torch.utils.paths import default_paths

    dataset = json.loads(pathlib.Path(sys.argv[1]).read_text())
    emb = Embedder(EmbedderConfig(model=BgeM3Config.tiny()), device="cpu")
    index, _, _ = CorpusIndexer(emb).build(
        build_synthetic_corpus(dataset)[:40])
    with tempfile.TemporaryDirectory() as tmp:
        paths = default_paths(tmp)
        index.save(paths.index_dir)
        stack = build_stack(paths=paths, llm=ExtractiveFakeLLM(),
                            embedder=emb, reranker=CrossEncoderReranker(
                                device="cpu"), device="cpu")
        resp = stack.pipeline.query(dataset[0]["question"])
    assert resp.sources and resp.error is None, resp

    cfg = TrainConfig(model=BgeM3Config.tiny(), warmup_steps=2)
    state = create_train_state(cfg, device="cpu")
    step = make_train_step(cfg, state)
    pairs = build_training_pairs(build_synthetic_corpus(dataset)[:40])
    batcher = PairBatcher(pairs, emb.tokenizer, 8, 32)
    for i in range(2):
        state, metrics = step(state, batcher.batch_at(i))
    assert state.step == 2 and float(metrics["loss"]) > 0
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = TrainCheckpointer(pathlib.Path(tmp) / "ckpt")
        assert ckpt.save(state)
        restored = ckpt.restore(create_train_state(cfg, rng_seed=1,
                                                   device="cpu"))
        assert restored.step == 2
        npz = pathlib.Path(tmp) / "encoder.npz"
        save_params_npz(state_dict_to_flax(state.model), npz)
        trained = Embedder(EmbedderConfig(model=BgeM3Config.tiny()),
                           params=load_params_npz(npz), device="cpu")
        assert trained.embed(["un texte"])["dense"].shape == (1, 64)

    # the MaxSim rerank over a tiny ColBERT index, and the replay's module
    from rag_dpo_tpu_torch.evals.hermetic import run_hermetic_replay
    from rag_dpo_tpu_torch.rag import create_pipeline
    from rag_dpo_tpu_torch.retrieval.reranker import MaxSimReranker

    cb_index, cb_stats, _ = CorpusIndexer(
        emb, with_colbert=True, colbert_len=64).build(
            build_synthetic_corpus(dataset)[:40])
    pipe = create_pipeline(cb_index, emb, ExtractiveFakeLLM(),
                           bm25_stats=cb_stats, use_maxsim=True)
    assert isinstance(pipe.reranker, MaxSimReranker)
    cb_resp = pipe.query(dataset[1]["question"])
    assert cb_resp.sources and cb_resp.error is None, cb_resp
    assert callable(run_hermetic_replay)

    # int8 storage and the postings engine (slice 4)
    import numpy as np
    from rag_dpo_tpu_torch.index import DeviceIndex, IndexConfig

    rng = np.random.default_rng(0)
    dense = rng.standard_normal((300, 64)).astype(np.float32)
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    terms = rng.integers(0, 50, (300, 8)).astype(np.int32)
    imps = np.abs(rng.standard_normal((300, 8))).astype(np.float32)
    i8 = DeviceIndex(IndexConfig(dim=64, ell_width=8, quantize_int8=True,
                                 postings_threshold=100), device="cpu")
    i8.add([f"r{i}" for i in range(300)], dense, terms=terms, impacts=imps)
    _, r8 = i8.search_dense(dense[:3], 5)
    assert (r8[:, 0] == [0, 1, 2]).all(), r8
    _, rp = i8.search_sparse(terms[:2, :4].copy(), np.ones((2, 4),
                                                           np.float32), 5)
    assert (rp[:, 0] >= 0).all(), rp

    # the per-segment candidates op (K5's entry point, slice 5)
    import torch
    from rag_dpo_tpu_torch.ops import fused_candidates_topk

    _, rc = fused_candidates_topk(torch.from_numpy(dense[:2]),
                                  torch.from_numpy(dense), 5, block_n=128,
                                  seg=32)
    assert rc[:, 0].tolist() == [0, 1], rc

    # the on-card int8 refine and the int8 sweep floor (slice 9)
    from rag_dpo_tpu_torch.ops.int8_matmul import int8_block_max

    for blocks in (0, 128):
        dr = DeviceIndex(IndexConfig(dim=64, ell_width=8, row_block=64,
                                     quantize_int8=True, device_refine=True,
                                     sweep_block_rows=blocks), device="cpu")
        dr.add([f"r{i}" for i in range(300)], dense)
        _, rd = dr.search_dense(dense[:3], 5)
        assert (rd[:, 0] == [0, 1, 2]).all(), rd
    e8 = torch.from_numpy(rng.integers(-127, 128, (300, 64)).astype(np.int8))
    strip = int8_block_max(e8[:2], e8, block=256, upcast="int8")
    dots = e8[:2].long() @ e8[:256].long().T
    assert strip.shape == (2, 128) and torch.equal(
        strip, dots.view(2, 2, 128).amax(1).float()), strip

    # the default config's serving path (slice 13): the provider factory,
    # the agent graph, the micro-batcher and try_build_stack
    import threading
    from rag_dpo_tpu_torch.agent import create_agent_pipeline
    from rag_dpo_tpu_torch.bootstrap import try_build_stack
    from rag_dpo_tpu_torch.providers import FakeLLMProvider, create_llm
    from rag_dpo_tpu_torch.serving import MicroBatcher

    assert type(create_llm("fake")) is FakeLLMProvider
    agent = create_agent_pipeline(index, emb, create_llm("fake"),
                                  bm25_stats=index.bm25_stats)
    agent_resp = agent.query(dataset[2]["question"])
    assert agent_resp.sources and agent_resp.error is None, agent_resp
    assert "generate" in agent_resp.extras["node_trace"]
    mb = MicroBatcher(lambda rows, key: (rows * 2,), max_batch=8,
                      max_wait_ms=20.0)
    outs = {}
    workers = [threading.Thread(target=lambda i=i: outs.update(
        {i: mb(np.full((1, 2), i))})) for i in range(4)]
    [w.start() for w in workers]
    [w.join() for w in workers]
    assert all((outs[i][0] == 2 * i).all() for i in range(4)), outs
    mb.close()
    with tempfile.TemporaryDirectory() as tmp:
        assert try_build_stack(default_paths(tmp), device="cpu") is None
        paths = default_paths(tmp)
        index.save(paths.index_dir)
        tried = try_build_stack(paths, llm=ExtractiveFakeLLM(),
                                device="cpu")
        assert tried.active() is tried.agent

    # the corpus build (slice 14): every ingest module, the rebuild CLI's
    # plan, an HTML page through the parser without bs4 or lxml, and the
    # C++ runtime's bindings
    import contextlib, io
    import rag_dpo_tpu_torch.ingest as ingest
    from rag_dpo_tpu_torch import native
    from rag_dpo_tpu_torch.ingest import (  # noqa: F401
        enterprise, images, rebuild, scraper, update, update_cli)

    plan = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(plan):
        assert rebuild.main(["--check", "--root", tmp, "--llm-mode",
                             "fake", "--device", "cpu"]) == 0
    assert json.loads(plan.getvalue())["would_run"] == ingest.STEP_ORDER
    sections = ingest.parse_document(
        "<html><body><div class='region-content'><h2>AIPD</h2><p>Une "
        "analyse d'impact.</p></div></body></html>".encode(), "html")
    assert [(x.heading, x.text) for x in sections] == [
        ("AIPD", "Une analyse d'impact.")], sections
    assert isinstance(native.is_available(), bool)

    # HF checkpoints and the app (slice 15): a `*.safetensors` snapshot
    # (written by the test with transformers) through the converter CLI
    # and `load_converted`, then the demo server's /query over loopback
    import os, threading, urllib.request
    from rag_dpo_tpu_torch.app.server import build_system, serve
    from rag_dpo_tpu_torch.models.convert_weights import (
        load_state_dict, main as convert_main)

    snapshot = pathlib.Path(sys.argv[2])
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "m3.npz"
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            assert convert_main(["bge-m3", str(snapshot), str(out)]) == 0
        assert "loaded 43 tensors" in printed.getvalue(), printed.getvalue()
        converted = Embedder(EmbedderConfig(model=BgeM3Config.tiny()),
                             params=load_params_npz(out), device="cpu")
        loaded = Embedder(EmbedderConfig(model=BgeM3Config.tiny()),
                          device="cpu")
        loaded.load_converted(load_state_dict(snapshot))
        a, b = (e.embed_queries(["un texte"]) for e in (converted, loaded))
        assert a.shape == (1, 64) and (a == b).all()
        os.environ["RAGDPO_TPU_ROOT"] = tmp
        system = build_system(agent_too=False, device="cpu")
        srv = serve(port=0, system=system)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/query",
            data=json.dumps({"question": dataset[3]["question"]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            served = json.loads(r.read())
        srv.shutdown()
        system["search"].batcher.close()
    assert served["answer"] and served["sources"], served

    # the in-process decoder (slice 16): the "tpu" provider through
    # create_llm (greedy with speculation, a sampled stream, choose) and
    # through build_stack's config
    from rag_dpo_tpu_torch.models import (  # noqa: F401
        decoder, generate, llava, speculative, vit)
    from rag_dpo_tpu_torch.providers import tpu_llm
    from rag_dpo_tpu_torch.providers.factory import create_tpu_llm
    from rag_dpo_tpu_torch.utils.config import load_config

    llm = create_llm("tpu", arch="tiny", speculative=True, device="cpu")
    said = llm.generate(dataset[0]["question"], max_tokens=6)
    assert said.ok and said.text and llm.spec_stats["calls"] == 1, said
    assert llm.choose("Intention :", ["oui", "non"])[0] in ("oui", "non")
    assert "".join(llm.generate_stream("X", max_tokens=4,
                                       temperature=0.8))
    # the continuous slot pool, with its prefix cache, chunked prefill,
    # preemption, logprobs and logit_bias, from three threads at once
    pool = create_tpu_llm(arch="tiny", scheduler="continuous", max_batch=2,
                          prefix_cache=2, prefix_block=8, prefill_chunk=16,
                          preemption=True, age_steps=2,
                          request_timeout_s=60, speculative=True,
                          device="cpu")
    sysmsg = ("Tu es un assistant juridique spécialisé dans le RGPD et la "
              "protection des données personnelles en France.")
    outs = {}
    workers = [threading.Thread(target=lambda i=i: outs.__setitem__(
        i, pool.generate(dataset[i]["question"], system=sysmsg,
                         max_tokens=6))) for i in range(3)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    assert all(r.ok and r.text for r in outs.values()), outs
    lp = pool.generate("X", max_tokens=4, logprobs=2,
                       logit_bias={5: 100.0})
    assert lp.ok and lp.logprobs and lp.logprobs[0]["id"] == 5, lp
    engine = pool._driver.engine
    assert engine.stats["admitted"] == 4 and engine.stats["prefix_hits"]
    # an image request through the pool's tiny LLaVA, one-shot and streamed
    # (the second from the patch cache)
    import io
    from PIL import Image
    lg = pool.attach_vision(vit.ViTConfig.tiny())
    png = io.BytesIO()
    Image.fromarray(np.random.default_rng(0).integers(
        0, 256, (40, 40, 3), dtype=np.uint8)).save(png, format="PNG")
    seen = pool.generate_with_image("Décris cette image.", png.getvalue(),
                                    max_tokens=6)
    assert seen.ok and seen.text, seen
    assert "".join(pool.generate_with_image_stream(
        "Décris cette image.", png.getvalue(), max_tokens=6)) == seen.text
    assert lg.cache_stats == {"hits": 1, "misses": 1}
    pool._driver.close()
    with tempfile.TemporaryDirectory() as tmp:
        paths = default_paths(tmp)
        index.save(paths.index_dir)
        tstack = build_stack(load_config(env={
            "RAGDPO_LLM_MODE": "tpu", "RAGDPO_LLM_ARCH": "tiny"}), paths,
            embedder=emb, device="cpu")
        assert type(tstack.llm) is tpu_llm.TPULLMProvider
        tresp = tstack.pipeline.query(dataset[4]["question"])
    # random weights cite no source: the answer stands ungrounded
    assert tresp.answer and tresp.error is None, tresp
    assert tresp.n_candidates > 0 and tresp.generation_time > 0, tresp
    # the mesh modules, and a world of one through the sharded store
    from rag_dpo_tpu_torch.index import DeviceIndex
    from rag_dpo_tpu_torch.models.sharding import shard_params  # noqa
    from rag_dpo_tpu_torch.ops.ring_attention import make_ring_attention
    from rag_dpo_tpu_torch.parallel import MeshSpec, create_mesh
    mesh = create_mesh(MeshSpec(shard=1), device_type="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        index.save(tmp)
        sharded = DeviceIndex.load(tmp, mesh=mesh)
    q = index.dense_vectors([3, 9])
    assert (sharded.search_dense(q, 5)[1]
            == index.search_dense(q, 5)[1]).all()
    assert sharded.search_dense(q, 5)[1][0, 0] == 3
    assert make_ring_attention(mesh)
    # the sharded train step on that world of one (slice 20)
    from rag_dpo_tpu_torch.train import make_sharded_train_step
    sh_step, sh_state = make_sharded_train_step(
        cfg, mesh, create_train_state(cfg, device="cpu"))
    sh_state, sh_metrics = sh_step(sh_state, batcher.batch_at(0))
    assert sh_state.step == 1 and float(sh_metrics["loss"]) > 0

    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                  "transformers", "safetensors",
                                  "rag_dpo_tpu", "bs4", "lxml")]
    assert not bad, bad
    print("OK", len(resp.sources), len(cb_resp.sources))
""")


def _tiny_hf_snapshot(path):
    """A `*.safetensors` XLM-R snapshot at `BgeM3Config.tiny()`'s widths,
    with FlagEmbedding's sparse and ColBERT sidecars."""
    from transformers import XLMRobertaConfig, XLMRobertaModel

    torch.manual_seed(0)
    XLMRobertaModel(XLMRobertaConfig(
        vocab_size=1024, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=514, type_vocab_size=1, pad_token_id=1,
        layer_norm_eps=1e-5)).save_pretrained(path, safe_serialization=True)
    torch.save(torch.nn.Linear(64, 1).state_dict(),
               path / "sparse_linear.pt")
    torch.save(torch.nn.Linear(64, 32).state_dict(),
               path / "colbert_linear.pt")
    return path


def test_port_runs_with_jax_refused_at_import(tmp_path):
    script = tmp_path / "blocked.py"
    script.write_text(BLOCKED_RUN)
    snapshot = _tiny_hf_snapshot(tmp_path / "snapshot")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, str(script), str(DATASET),
                           str(snapshot)],
                          capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")
