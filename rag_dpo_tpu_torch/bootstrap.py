"""Bootstrap: FrameworkConfig + on-disk artifacts → the ready query pipeline.

Port of `rag_dpo_tpu/bootstrap.py` for slice 1 of the port: the typed
config (`utils.config`, the JAX package's, copied) drives the index,
embedder, BM25 stats, summary prefilter, retriever recipe, reranker, LLM
provider, query logger and alerter of the sequential `RAGPipeline`.

Not in this slice, and raising `NotImplementedError` that names the
ROADMAP item: the agent pipeline (`Stack.agent` is None), LLM modes other
than an injected provider or `fake`, and the coalescing batchers.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Any

from .utils.config import FrameworkConfig, load_config
from .utils.paths import Paths, default_paths

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Stack:
    config: FrameworkConfig
    paths: Paths
    index: Any
    embedder: Any
    bm25_stats: Any
    summary_index: Any
    llm: Any
    pipeline: Any          # sequential RAGPipeline
    agent: Any             # None until the agent is ported
    query_logger: Any
    alerter: Any

    def active(self, use_agent: bool | None = None):
        if use_agent is None:
            use_agent = self.config.agent.enable
        if use_agent:
            raise NotImplementedError(
                "the agent pipeline is not ported yet (ROADMAP, port queue "
                "item 2: agent/)")
        return self.pipeline


def _load_bm25_stats(index):
    """Query-side BM25 stats come from the index checkpoint (bm25.json):
    its vocab is the term-id space of the stored ELL arrays."""
    if index.bm25_stats is not None:
        return index.bm25_stats
    raise RuntimeError(
        "index checkpoint has no persisted BM25 stats (bm25.json) — "
        "rebuild it with the corpus indexer (any build persists the "
        "stats), or disable hybrid retrieval in the config"
    )


def _create_llm(config: FrameworkConfig):
    if config.llm.mode == "fake":
        from .providers import FakeLLMProvider

        return FakeLLMProvider()
    raise NotImplementedError(
        f"LLM mode {config.llm.mode!r} is not ported yet (ROADMAP, port "
        "queue item 7: generation and serving); inject an llm or use "
        "mode 'fake'")


def build_stack(
    config: FrameworkConfig | None = None,
    paths: Paths | None = None,
    llm=None,
    index=None,
    embedder=None,
    reranker=None,
    device=None,
) -> Stack:
    """Load the saved index + summaries and wire the pipeline per config.
    Components may be injected; anything not injected is built on
    `device` (default: the first CUDA card, else the CPU)."""
    from .index import DeviceIndex
    from .providers import Embedder, EmbedderConfig
    from .rag import create_pipeline
    from .retrieval import SummaryBm25Index
    from .utils import Alerter, AlertConfig, QueryLogger

    config = config or load_config()
    paths = (paths or default_paths()).ensure()
    if config.embedding.query_batch > 0 or config.retrieval.rerank_batch > 0:
        raise NotImplementedError(
            "coalesced query/rerank batching is not ported yet (ROADMAP, "
            "port queue item 7: serving)")

    if llm is None:
        llm = _create_llm(config)
    if index is None:
        manifest = paths.index_dir / "manifest.json"
        if not manifest.exists():
            raise FileNotFoundError(
                f"no index at {paths.index_dir} — build one with "
                "rag_dpo_tpu_torch.ingest.CorpusIndexer and "
                "DeviceIndex.save"
            )
        index = DeviceIndex.load(paths.index_dir, device=device)
    if config.retrieval.postings_candidates:
        # serving-time override of the sparse rescore pool, kept so the
        # index config round-trips like the JAX package's
        index.config = dataclasses.replace(
            index.config,
            postings_candidates=int(config.retrieval.postings_candidates))

    if embedder is None:
        kwargs = dict(
            batch_size=config.embedding.batch_size,
            max_seq_len=config.embedding.max_seq_len,
            query_max_len=config.embedding.query_max_len,
        )
        ckpt = config.embedding.checkpoint_path
        if ckpt:
            # converted real weights → production-size architecture
            from .models.bge_m3 import BgeM3Config
            from .models.convert import load_params_npz

            embedder = Embedder(
                EmbedderConfig(model=BgeM3Config(), **kwargs),
                params=load_params_npz(ckpt), device=device,
            )
        else:
            embedder = Embedder(EmbedderConfig(**kwargs), device=device)

    # the query encoder MUST produce vectors in the index's space
    if embedder.dim != index.config.dim:
        raise ValueError(
            f"embedder dim {embedder.dim} ≠ index dim "
            f"{index.config.dim}: the saved index was built with a "
            "different encoder. Set RAGDPO_EMBEDDING_CHECKPOINT_PATH "
            "(converted weights npz) or inject the matching embedder."
        )

    bm25_stats = None
    if config.retrieval.hybrid:
        bm25_stats = _load_bm25_stats(index)

    summary_index = None
    if paths.document_summaries.exists():
        summaries = json.loads(paths.document_summaries.read_text())
        summary_index = SummaryBm25Index(device=index.device)
        summary_index.build([
            {"doc_key": key, "title": fiche.get("title", ""),
             "summary": fiche.get("summary", ""),
             "url": fiche.get("url", "")}
            for key, fiche in summaries.items()
            if not fiche.get("navigation")
        ])

    r = config.retrieval
    from .retrieval.retriever import RetrieverConfig

    retriever_config = RetrieverConfig(
        n_expansions=r.n_expansions,
        rrf_k=r.rrf_k,
        prefilter_top_docs=r.prefilter_top_docs,
        per_arm_k=r.n_candidates,
        use_sparse=r.hybrid,
        dense_exact=r.dense_exact,
    )
    if reranker is None and r.use_reranker:
        from .retrieval.reranker import default_reranker

        reranker = default_reranker(embedder)
    pipeline = create_pipeline(
        index, embedder, llm,
        bm25_stats=bm25_stats, summary_index=summary_index, texts=None,
        retriever_config=retriever_config,
        use_reranker=r.use_reranker,
        reranker=reranker,
        intent_fast=r.intent_fast,
        expansion_parallel=r.expansion_parallel,
        n_candidates=r.n_candidates,
        rerank_top_k=r.rerank_top_k,
        max_context_chars=r.max_context_chars,
        generation_temperature=config.llm.temperature,
    )

    o = config.observability
    query_logger = QueryLogger(paths.queries_log, paths.feedback_log,
                               rotate_mb=o.query_log_rotate_mb)
    alerter = Alerter(query_logger, paths.alerts_log, AlertConfig(
        error_rate=o.alert_error_rate,
        avg_time_s=o.alert_avg_time_s,
        satisfaction=o.alert_satisfaction,
        zero_citation_rate=o.alert_zero_citation_rate,
        smtp_enabled=o.smtp_enabled,
        smtp_host=o.smtp_host,
        smtp_to=o.smtp_to,
    ))
    return Stack(
        config=config, paths=paths, index=index, embedder=embedder,
        bm25_stats=bm25_stats, summary_index=summary_index, llm=llm,
        pipeline=pipeline, agent=None,
        query_logger=query_logger, alerter=alerter,
    )
