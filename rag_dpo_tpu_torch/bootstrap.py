"""Bootstrap: FrameworkConfig + on-disk artifacts → the ready pipelines.

Port of `rag_dpo_tpu/bootstrap.py`: the typed config (`utils.config`, the
JAX package's, copied) drives the index, embedder, BM25 stats, summary
prefilter, retriever recipe, the one reranker both orchestrators share,
the LLM provider (`providers.factory.create_llm`), the sequential
`RAGPipeline`, the agent (`agent.create_agent_pipeline`), the coalescing
batchers of query encode and rerank, the query logger and the alerter.
`try_build_stack` is the app surfaces' selection rule. Only `llm.mode
"tpu"`, the in-process decoder, still raises (ROADMAP item 7b).
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
    agent: Any             # RAGAgentPipeline
    query_logger: Any
    alerter: Any

    def active(self, use_agent: bool | None = None):
        if use_agent is None:
            use_agent = self.config.agent.enable
        return self.agent if use_agent else self.pipeline


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
    """The configured provider; mode "tpu" gets the decoder's settings, as
    in the JAX bootstrap (and raises until the decoder is ported)."""
    from .providers.factory import create_llm

    c = config.llm
    tpu_kwargs = {}
    if c.mode == "tpu":
        tpu_kwargs = dict(
            checkpoint_path=c.checkpoint_path,
            tokenizer_path=c.tokenizer_path,
            arch=c.arch,
            quantize_int8=c.quantize_int8,
            quantize_kv=c.quantize_kv,
            scheduler=c.scheduler,
            speculative=c.speculative,
            max_batch=c.max_batch,
            prefix_cache=c.prefix_cache,
            prefix_block=c.prefix_block,
            prefix_cache_host=c.prefix_cache_host,
            prefill_chunk=c.prefill_chunk,
            decode_chunk=c.decode_chunk,
            top_p=c.top_p,
            request_timeout_s=c.request_timeout_s or None,
            age_steps=c.age_steps,
            preemption=c.preemption,
            choose_batch=c.choose_batch,
        )
    return create_llm(c.mode, base_url=c.base_url, model=c.model,
                      **tpu_kwargs)


def try_build_stack(paths: Paths | None = None, llm=None,
                    config_path=None, device=None) -> "Stack | None":
    """The app surfaces' selection rule: a saved index checkpoint routes
    to the config-driven stack; None means there is none (the JAX
    package's surfaces then fall back to their demo stack)."""
    paths = paths or default_paths()
    if not (paths.index_dir / "manifest.json").exists():
        return None
    return build_stack(load_config(config_path), paths, llm=llm,
                       device=device)


def build_stack(
    config: FrameworkConfig | None = None,
    paths: Paths | None = None,
    llm=None,
    index=None,
    embedder=None,
    reranker=None,
    device=None,
) -> Stack:
    """Load the saved index + summaries and wire both orchestrators per
    config. Components may be injected; anything not injected is built on
    `device` (default: the first CUDA card; `"cpu"` must be asked for)."""
    from .agent import create_agent_pipeline
    from .index import DeviceIndex
    from .providers import Embedder, EmbedderConfig
    from .rag import create_pipeline
    from .retrieval import SummaryBm25Index
    from .utils import Alerter, AlertConfig, QueryLogger

    config = config or load_config()
    paths = (paths or default_paths()).ensure()

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
    # injected embedders too (enable is idempotent), as in the JAX
    # bootstrap: the config said coalesce
    if config.embedding.query_batch > 0 and \
            hasattr(embedder, "enable_query_batching"):
        embedder.enable_query_batching(
            max_batch=int(config.embedding.query_batch))

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
    # ONE cross-encoder for both orchestrators: one set of weights on the
    # card, and pair-scoring coalesces across both when rerank_batch is on
    if reranker is None and r.use_reranker:
        from .retrieval.reranker import default_reranker

        reranker = default_reranker(embedder, rerank_batch=r.rerank_batch)
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
    agent = create_agent_pipeline(
        index, embedder, llm,
        bm25_stats=bm25_stats, summary_index=summary_index, texts=None,
        retriever_config=retriever_config,
        reranker=reranker,
        n_candidates=r.n_candidates,
        rerank_top_k=r.rerank_top_k,
        max_context_chars=r.max_context_chars,
        enable_expert_refinement=config.agent.enable_expert_refinement,
        enable_completeness=config.agent.enable_completeness,
        generation_temperature=config.llm.temperature,
        intent_fast=r.intent_fast,
        expansion_parallel=r.expansion_parallel,
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
        pipeline=pipeline, agent=agent,
        query_logger=query_logger, alerter=alerter,
    )
