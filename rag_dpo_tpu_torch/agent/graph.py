"""Explicit agent state machine (role parity: src/rag/agent/graph.py).

The reference builds a LangGraph StateGraph with 9 nodes and 3 conditional
edges (`build_graph` :61-205). The graph is static, so this is a plain
Python control-flow implementation of the same topology — no framework:

    rewrite → classify
      ├─(refusal keyword-confirmed)→ refusal → END
      └─ enrich → decompose → retrieve → generate
            → [expert_refinement] → validate
               ├─(severe, retries left)→ generate          (retry loop)
               └─ check_completeness
                    ├─(coverage < 80%, re-retrievals left)→ retrieve
                    └─ respond → END

`RAGAgentPipeline.query()` returns the same RAGResponse as the sequential
pipeline (reference :212-329), so the two orchestrators are drop-in
interchangeable (the UI toggles them at runtime).
"""

from __future__ import annotations

from typing import Sequence

from ..rag.pipeline import RAGResponse
from ..utils.profiling import collect_spans, span, span_rows, span_seconds
from . import nodes
from .nodes import NodeComponents
from .state import AgentState


class AgentGraph:
    def __init__(self, components: NodeComponents):
        self.c = components

    def run(self, state: AgentState) -> AgentState:
        c = self.c
        state = nodes.rewrite(c, state)
        # classify ∥ decompose ∥ candidate prefetch (all read the
        # post-rewrite question) — three serial stages become one
        state = nodes.overlap_prepare(c, state)

        if state.intent.is_refusal:
            subtype = nodes.confirm_refusal_keyword(state.question)
            if subtype is not None:  # refusal only when keyword-confirmed
                state.refusal_type = subtype
                state = nodes.refusal(c, state)
                return nodes.respond(c, state)
            state.intent.intent = "factuel"  # LLM refus unconfirmed

        state = nodes.enrich(c, state)
        state = nodes.retrieve(c, state)

        while True:
            state = nodes.generate(c, state)
            if c.enable_expert_refinement:
                state = nodes.expert_refinement(c, state)
            state = nodes.validate(c, state)
            if nodes.should_retry_generation(c, state):
                state.generation_retries += 1
                continue

            if c.enable_completeness and not state.error:
                state = nodes.check_completeness(c, state)
                if nodes.should_re_retrieve(c, state):
                    state.re_retrievals += 1
                    state = nodes.retrieve(c, state)
                    continue
            break

        return nodes.respond(c, state)


class RAGAgentPipeline:
    def __init__(self, components: NodeComponents):
        self.graph = AgentGraph(components)
        self.components = components

    def query(
        self,
        question: str,
        where_filter: dict | None = None,
        enterprise_tags: Sequence[str] | None = None,
        conversation_history: Sequence[dict] | None = None,
        n_documents: int = 5,
        n_chunks_per_doc: int = 3,
        temperature: float | None = None,
        on_delta=None,
    ) -> RAGResponse:
        state = AgentState(
            question=question,
            conversation_history=list(conversation_history or []),
            where_filter=where_filter,
            enterprise_tags=list(enterprise_tags or []),
            n_documents=n_documents,
            n_chunks_per_doc=n_chunks_per_doc,
            temperature=temperature,
            on_delta=on_delta,
        )
        with collect_spans() as spans, span("agent.query") as whole:
            state = self.graph.run(state)
        timings = state.timings
        return RAGResponse(
            answer=state.answer,
            question=question,
            sources=state.built_sources,
            intent=state.intent.intent,
            topics=state.intent.topics,
            model=state.model,
            retrieval_time=timings.get("retrieve", 0.0),
            rerank_time=span_seconds(spans, "rerank"),
            generation_time=timings.get("generate", 0.0),
            validation_time=timings.get("validate", 0.0),
            total_time=whole.seconds,
            n_candidates=state.n_candidates,
            grounded=state.grounded,
            grounding_issues=state.grounding_issues,
            retried=state.generation_retries > 0 or state.re_retrievals > 0,
            error=state.error,
            extras={
                "node_trace": state.node_trace,
                "sub_questions": state.sub_questions,
                "coverage_pct": state.coverage_pct,
                "detected_articles": [a["numero"] for a in
                                      state.detected_articles],
                "refusal_type": state.refusal_type,
                "rewritten_question": state.question,
            },
            spans=span_rows(spans),
        )


    def query_stream(
        self,
        question: str,
        where_filter: dict | None = None,
        enterprise_tags: Sequence[str] | None = None,
        conversation_history: Sequence[dict] | None = None,
        n_documents: int = 5,
        n_chunks_per_doc: int = 3,
        temperature: float | None = None,
    ):
        """Streaming agent query — same event protocol as
        `RAGPipeline.query_stream`: ("delta", str) as the generate node
        produces answer text, ("reset", None) when a grounding retry or
        re-retrieval regenerates (the client discards the draft), then
        one final ("response", RAGResponse) with the post-processed
        answer. The graph runs in a worker thread; deltas cross over a
        queue so the caller iterates while generation is in flight.

        Closing this generator early does NOT cancel the in-flight
        graph run (unlike `RAGPipeline.query_stream`, whose LLM stream
        close cancels the decode request): the worker owns a full
        `query()` whose retry/validation ladder must not observe a
        consumer-side abort as a generation failure. The run completes
        in the background and its slot frees at its natural end."""
        import queue as _queue
        import threading as _threading

        q: _queue.Queue = _queue.Queue()
        _DONE = object()

        def on_delta(d):
            q.put(("delta", d) if d is not None else ("reset", None))

        def run():
            try:
                resp = self.query(
                    question,
                    where_filter=where_filter,
                    enterprise_tags=enterprise_tags,
                    conversation_history=conversation_history,
                    n_documents=n_documents,
                    n_chunks_per_doc=n_chunks_per_doc,
                    temperature=temperature,
                    on_delta=on_delta,
                )
                q.put(("response", resp))
            except BaseException as e:  # noqa: BLE001 — surface to caller
                q.put(("error", e))
            finally:
                q.put(_DONE)

        worker = _threading.Thread(target=run, daemon=True,
                                   name="agent-query-stream")
        worker.start()
        while True:
            item = q.get()
            if item is _DONE:
                break
            if item[0] == "error":
                raise item[1]
            yield item
        worker.join(timeout=5)


def create_agent_pipeline(
    index,
    embedder,
    llm,
    bm25_stats=None,
    summary_index=None,
    texts=None,
    reranker=None,
    use_expansion: bool = True,
    expansion_parallel: bool | None = None,
    retriever_config=None,
    n_candidates: int = 40,
    rerank_top_k: int = 10,
    max_context_chars: int = 32_000,
    enable_expert_refinement: bool = False,
    enable_completeness: bool = True,
    generation_temperature: float = 0.1,
    intent_fast: bool | None = None,
) -> RAGAgentPipeline:
    """Factory (reference `create_agent_pipeline` graph.py:336-471) —
    builds the same shared components as the sequential factory."""
    from ..rag.context import ContextBuilder
    from ..rag.expander import QueryExpander
    from ..rag.generator import Generator
    from ..rag.intent import IntentClassifier
    from ..rag.validators import GroundingValidator
    from ..retrieval.retriever import HybridRetriever, RetrieverConfig

    retriever = HybridRetriever(
        index, embedder, bm25_stats=bm25_stats, summary_index=summary_index,
        query_expander=QueryExpander(llm, parallel=expansion_parallel)
        if use_expansion else None,
        texts=texts, config=retriever_config or RetrieverConfig(),
    )
    components = NodeComponents(
        llm=llm,
        retriever=retriever,
        generator=Generator(llm, temperature=generation_temperature),
        context_builder=ContextBuilder(
            llm=llm, max_context_chars=max_context_chars
        ),
        # agent default: the constrained-choice intent path whenever
        # the provider can score choices (12.3× faster classification
        # at 12B — BENCHMARKS.md "Fast intent"; the agent graph is the
        # reference's headline config, so its default gets the native
        # path's serving economics). Pass intent_fast=False to force
        # the JSON classifier.
        intent_classifier=IntentClassifier(
            llm,
            fast=(hasattr(llm, "choose") if intent_fast is None
                  else intent_fast)),
        grounding_validator=GroundingValidator(),
        reranker=reranker,
        n_candidates=n_candidates,
        rerank_top_k=rerank_top_k,
        enable_expert_refinement=enable_expert_refinement,
        enable_completeness=enable_completeness,
    )
    return RAGAgentPipeline(components)
