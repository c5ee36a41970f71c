"""Sequential RAG orchestrator — the native (non-agent) query path.

Role parity with `src/rag/pipeline.py` (1103 LoC). Flow (reference
`query()` :170-593):

  enterprise-tag filter build (:35-71) → intent classify → retrieve
  candidates (40) → rerank (40→10) → rebuild documents from ranked chunks
  (:805-879) → context build → generate → deterministic grounding
  validation (+invented-source autofix) → quality-retry with more
  documents (:508-540) → markdown fixup (:595-661) → cited-source
  renumbering. Relevance validation is skipped when the reranker is on
  (:295-299). Optional dual-generation with stance comparison
  (:663-803) is off by default — the reference's published 90.4% uses
  single-gen.

The retrieval stages run on TPU (see retrieval/); this module is host
orchestration and prompt logic only.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Sequence

from ..retrieval.types import (  # noqa: F401 — re-exports kept for callers
    RetrievedChunk,
    RetrievedDocument,
    normalize_doc_key,
    rebuild_documents_from_ranked_chunks,
)
from .context import BuiltContext, ContextBuilder, fix_markdown_formatting
from .generator import GeneratedResponse, Generator
from .intent import IntentClassifier, QuestionIntent
from .validators import GroundingValidator, RelevanceValidator
from ..utils.profiling import collect_spans, span, span_rows


def build_enterprise_where_filter(
    enterprise_tags: Sequence[str] | None,
    base_filter: dict | None = None,
) -> dict | None:
    """Enterprise-tag filter: docs carrying ANY selected tag, OR all CNIL
    docs (reference semantics `pipeline.py:35-71`: boolean `tag_<name>`
    metadata fields from ingest, $or-composed with the base filter)."""
    if not enterprise_tags:
        return base_filter
    from ..ingest.enterprise import _slug

    clauses: list[dict] = [{"source": "CNIL"}]
    for tag in enterprise_tags:
        # same slug normalization the ingestor applies when it writes
        # the tag_<slug> metadata fields — a raw UI label ("RH") must
        # match the stored field ("tag_rh")
        clauses.append({f"tag_{_slug(tag)}": True})
    tag_filter = {"$or": clauses}
    if base_filter:
        return {"$and": [base_filter, tag_filter]}
    return tag_filter


@dataclasses.dataclass
class RAGResponse:
    answer: str
    question: str
    sources: list[dict]
    intent: str = "factuel"
    topics: list[str] = dataclasses.field(default_factory=list)
    model: str = ""
    retrieval_time: float = 0.0
    rerank_time: float = 0.0
    generation_time: float = 0.0
    validation_time: float = 0.0
    total_time: float = 0.0
    n_candidates: int = 0
    grounded: bool = True
    grounding_issues: list[str] = dataclasses.field(default_factory=list)
    retried: bool = False
    error: str | None = None
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)
    # the query's spans: (name, start epoch ns, duration ns, parent's
    # index or -1, thread), in the order they started
    spans: list[tuple] = dataclasses.field(default_factory=list)


_STANCE_YES = re.compile(r"^\s*(?:\*\*)?\s*oui\b", re.IGNORECASE)
_STANCE_NO = re.compile(r"^\s*(?:\*\*)?\s*non\b", re.IGNORECASE)


def detect_stance(answer: str) -> str:
    """'oui' / 'non' / 'neutre' from the answer opening (reference
    `_detect_stance` :761-803 is the same regex idea)."""
    if _STANCE_YES.search(answer):
        return "oui"
    if _STANCE_NO.search(answer):
        return "non"
    return "neutre"


class RAGPipeline:
    def __init__(
        self,
        retriever,
        generator: Generator,
        context_builder: ContextBuilder,
        intent_classifier: IntentClassifier | None = None,
        reranker=None,
        grounding_validator: GroundingValidator | None = None,
        relevance_validator: RelevanceValidator | None = None,
        n_candidates: int = 40,
        rerank_top_k: int = 10,
        enable_dual_generation: bool = False,
        max_quality_retries: int = 1,
        retry_extra_docs: int = 4,
        overlap_intent: bool = True,
    ):
        self.retriever = retriever
        self.generator = generator
        self.context_builder = context_builder
        self.intent_classifier = intent_classifier
        self.reranker = reranker
        self.grounding_validator = grounding_validator or GroundingValidator()
        self.relevance_validator = relevance_validator
        self.n_candidates = n_candidates
        self.rerank_top_k = rerank_top_k
        self.enable_dual_generation = enable_dual_generation
        self.max_quality_retries = max_quality_retries
        self.retry_extra_docs = retry_extra_docs
        self.overlap_intent = overlap_intent

    def _classify_concurrent(self, question: str):
        """Start intent classification NOW, return a join() →
        QuestionIntent.

        The reference runs classify → expand → search strictly
        sequentially (`src/rag/pipeline.py:215,224`); but the intent
        result is first consumed at the RERANK stage (topic boost), and
        the expansion LLM call inside `retriever._queries` doesn't
        depend on it — so both LLM calls can be in flight together.
        Behind the continuous slot pool (providers/tpu_llm.py) they
        co-reside and share weight sweeps, collapsing the aux-call
        latency from intent+expansion to ~max(intent, expansion); over
        HTTP providers they simply overlap network round-trips."""
        if self.intent_classifier is None:
            intent = QuestionIntent()
            return lambda: intent
        if not self.overlap_intent:
            intent = self.intent_classifier.classify(question)
            return lambda: intent
        import threading

        box: dict = {}

        def run():
            # classify() already degrades to 'factuel' internally on
            # provider errors; this guard keeps join() total anyway
            try:
                box["intent"] = self.intent_classifier.classify(question)
            except Exception:
                box["intent"] = QuestionIntent()

        th = threading.Thread(target=run, name="intent-classify",
                              daemon=True)
        th.start()

        def join() -> QuestionIntent:
            th.join()
            return box.get("intent") or QuestionIntent()

        return join

    # ------------------------------------------------------------- public
    def query(
        self,
        question: str,
        where_filter: dict | None = None,
        enterprise_tags: Sequence[str] | None = None,
        conversation_history: Sequence[dict] | None = None,
        n_documents: int = 5,
        n_chunks_per_doc: int = 3,
        temperature: float | None = None,
    ) -> RAGResponse:
        with collect_spans() as spans, span("pipeline.query") as whole:
            response = self._query(question, where_filter, enterprise_tags,
                                   conversation_history, n_documents,
                                   n_chunks_per_doc, temperature)
        response.total_time = whole.seconds
        response.spans = span_rows(spans)
        return response

    def _query(self, question, where_filter, enterprise_tags,
               conversation_history, n_documents, n_chunks_per_doc,
               temperature) -> RAGResponse:
        where = build_enterprise_where_filter(enterprise_tags, where_filter)

        # --- intent (classification overlaps expansion+search)
        intent_join = self._classify_concurrent(question)

        # --- retrieval
        with span("pipeline.retrieve") as sp:
            documents, candidates, rerank_time, intent = self._retrieve(
                question, where, intent_join, n_documents, n_chunks_per_doc
            )
        retrieval_time = sp.seconds - rerank_time

        if not documents:
            return RAGResponse(
                answer=("Je n'ai trouvé aucun document pertinent pour cette "
                        "question dans la base documentaire."),
                question=question,
                sources=[],
                intent=intent.intent,
                topics=intent.topics,
                retrieval_time=retrieval_time,
                n_candidates=0,
            )

        # --- generation (with quality retry ladder)
        answer, built, gen, grounding, retried = self._generate_validated(
            question, documents, intent, conversation_history, temperature,
            where, n_documents, n_chunks_per_doc,
        )

        return self._final_response(
            answer, question, intent, built, gen, grounding, retried,
            retrieval_time, rerank_time, len(candidates),
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
        """Streaming variant of `query`: yields ("delta", str) events as
        the LLM produces the answer, then ONE ("response", RAGResponse)
        carrying the fully post-processed answer (markdown fixup +
        cited-source renumbering applied once the stream completes —
        clients replace the streamed draft with it). Same stages and
        semantics as `query`; with a greedy deterministic LLM and no
        quality retry, the final answer equals the oneshot `query`
        answer exactly (tests/test_streaming_query.py). When the
        quality-retry ladder replaces the answer, the final response
        carries the improved (non-streamed) answer. Dual generation is
        bypassed on this path (two parallel samples can't stream as
        one). The reference's chat surface blocks ~39 s with zero
        output (`pages/1_💬_Chat.py:312`); here first tokens arrive as
        soon as retrieval (+TTFT) completes."""
        # the whole and the generation span the consumer's yields, which a
        # span (a context variable) may not: the monotonic clock times them
        t_start = time.perf_counter()
        where = build_enterprise_where_filter(enterprise_tags,
                                              where_filter)
        intent_join = self._classify_concurrent(question)

        with span("pipeline.retrieve") as sp:
            documents, candidates, rerank_time, intent = self._retrieve(
                question, where, intent_join, n_documents, n_chunks_per_doc
            )
        retrieval_time = sp.seconds - rerank_time

        if not documents:
            yield ("response", RAGResponse(
                answer=("Je n'ai trouvé aucun document pertinent pour "
                        "cette question dans la base documentaire."),
                question=question,
                sources=[],
                intent=intent.intent,
                topics=intent.topics,
                retrieval_time=retrieval_time,
                total_time=time.perf_counter() - t_start,
                n_candidates=0,
            ))
            return

        # --- streamed first generation
        built = self.context_builder.build_context(
            question, documents, intent=intent.intent,
            negative_topics=intent.negative_topics,
            conversation_history=conversation_history,
        )
        t0 = time.perf_counter()
        pieces: list[str] = []
        err = None
        # hold the LLM stream so an abandoned consumer (client
        # disconnect → GeneratorExit lands at our yield) closes it
        # DETERMINISTICALLY — on the continuous scheduler that cancels
        # the decode request and frees its slot at the next step,
        # instead of waiting for refcount GC to do it
        llm_stream = self.generator.stream(
            built.system_prompt, built.user_prompt, temperature)
        try:
            try:
                for delta in llm_stream:
                    pieces.append(delta)
                    yield ("delta", delta)
            except Exception as e:  # noqa: BLE001 — degrade in-band
                err = f"{type(e).__name__}: {e}"
        finally:
            llm_stream.close()
        text = "".join(pieces)
        gen = GeneratedResponse(
            text=text,
            model=getattr(self.generator.llm, "model_name", ""),
            generation_time=time.perf_counter() - t0,
            error=err or ("réponse vide du modèle"
                          if not text.strip() else None),
        )

        # --- validation + retry ladder, formatting (shared with query)
        answer, built, gen, grounding, retried = self._generate_validated(
            question, documents, intent, conversation_history,
            temperature, where, n_documents, n_chunks_per_doc,
            first=(built, gen),
        )
        response = self._final_response(
            answer, question, intent, built, gen, grounding, retried,
            retrieval_time, rerank_time, len(candidates),
        )
        response.total_time = time.perf_counter() - t_start
        yield ("response", response)

    # ------------------------------------------------------------ helpers
    def _final_response(self, answer, question, intent, built, gen,
                        grounding, retried, retrieval_time, rerank_time,
                        n_candidates) -> RAGResponse:
        with span("pipeline.format") as sp:
            answer = fix_markdown_formatting(answer)
            answer, used_sources = self.context_builder.\
                format_response_with_sources(answer, built.sources)
        return RAGResponse(
            answer=answer,
            question=question,
            sources=used_sources,
            intent=intent.intent,
            topics=intent.topics,
            model=gen.model,
            retrieval_time=retrieval_time,
            rerank_time=rerank_time,
            generation_time=gen.generation_time,
            validation_time=sp.seconds,
            n_candidates=n_candidates,
            grounded=grounding.grounded,
            grounding_issues=grounding.issues,
            retried=retried,
            error=gen.error,
        )
    def _retrieve(self, question, where, intent, n_documents,
                  n_chunks_per_doc):
        """→ (documents, candidates, rerank_time, intent). `intent` may
        be a QuestionIntent or a join() callable from
        `_classify_concurrent` — it is resolved as late as possible
        (rerank is its first consumer), which is what lets the intent
        LLM call overlap the expansion+search phase."""
        rerank_time = 0.0
        if self.reranker is not None:
            candidates = self.retriever.retrieve_candidates(
                question, n_candidates=self.n_candidates, where=where
            )
            if callable(intent):
                intent = intent()
            with span("pipeline.rerank") as sp:
                ranked = self.reranker.rerank(
                    question, candidates, top_k=self.rerank_top_k,
                    question_topics=intent.topics,
                )
            rerank_time = sp.seconds
            documents = rebuild_documents_from_ranked_chunks(
                ranked, n_documents, n_chunks_per_doc
            )
            return documents, candidates, rerank_time, intent
        documents = self.retriever.retrieve(
            question, n_documents=n_documents,
            n_chunks_per_doc=n_chunks_per_doc, where=where,
        )
        if callable(intent):
            intent = intent()
        if self.relevance_validator is not None:
            documents = [
                RetrievedDocument(
                    doc_key=d.doc_key, title=d.title, score=d.score,
                    chunks=self.relevance_validator.filter_chunks(d.chunks),
                )
                for d in documents
            ]
            documents = [d for d in documents if d.chunks]
        return (documents, [c for d in documents for c in d.chunks], 0.0,
                intent)

    def _generate_once(self, question, documents, intent, history,
                       temperature):
        built = self.context_builder.build_context(
            question, documents, intent=intent.intent,
            negative_topics=intent.negative_topics,
            conversation_history=history,
        )
        if self.enable_dual_generation:
            gen = self._dual_generate(built, temperature)
        else:
            gen = self.generator.generate(
                built.system_prompt, built.user_prompt,
                temperature=temperature,
            )
        return built, gen

    def _generate_validated(self, question, documents, intent, history,
                            temperature, where, n_documents,
                            n_chunks_per_doc, first=None):
        """Validation + quality-retry ladder around the first generation.
        `first=(built, gen)` injects an attempt already produced (the
        streaming path) instead of generating here."""
        retried = False
        built, gen = first if first is not None else self._generate_once(
            question, documents, intent, history, temperature
        )
        answer = gen.text
        grounding = self.grounding_validator.validate(
            answer, built.context_text, n_sources=len(built.sources)
        )
        if grounding.invented_sources:
            answer = self.grounding_validator.fix_invented_sources(
                answer, len(built.sources)
            )

        # quality retry: fetch more documents when the answer is evasive or
        # citation-free (reference recursive retry :508-540)
        needs_retry = (
            not grounding.has_citations
            or any("évasive" in i for i in grounding.issues)
            or not gen.ok
        )
        if needs_retry and self.max_quality_retries > 0:
            retried = True
            more_docs = self._retrieve(
                question, where, intent,
                n_documents + self.retry_extra_docs, n_chunks_per_doc,
            )[0]
            if more_docs:
                built2, gen2 = self._generate_once(
                    question, more_docs, intent, history, temperature
                )
                grounding2 = self.grounding_validator.validate(
                    gen2.text, built2.context_text, len(built2.sources)
                )
                better = (
                    (grounding2.has_citations
                     and not grounding.has_citations)
                    or (gen2.ok and not gen.ok)
                    or len(grounding2.issues) < len(grounding.issues)
                )
                if better:
                    answer = gen2.text
                    if grounding2.invented_sources:
                        answer = self.grounding_validator.\
                            fix_invented_sources(answer,
                                                 len(built2.sources))
                    built, gen, grounding = built2, gen2, grounding2
        return answer, built, gen, grounding, retried

    def _dual_generate(self, built: BuiltContext,
                       temperature) -> GeneratedResponse:
        """Dual generation + stance selection (reference
        `_select_dual_response` :663-759): two samples; on stance
        disagreement prefer the one with more citations, else A."""
        gen_a = self.generator.generate(
            built.system_prompt, built.user_prompt, temperature=temperature
        )
        gen_b = self.generator.generate(
            built.system_prompt, built.user_prompt,
            temperature=0.4 if temperature is None else temperature + 0.3,
        )
        if not gen_a.ok:
            return gen_b
        if not gen_b.ok:
            return gen_a
        stance_a, stance_b = detect_stance(gen_a.text), \
            detect_stance(gen_b.text)
        if stance_a != stance_b:
            from .validators import extract_citations

            if len(extract_citations(gen_b.text)) > \
                    len(extract_citations(gen_a.text)):
                return gen_b
        return gen_a


def create_pipeline(
    index,
    embedder,
    llm,
    bm25_stats=None,
    summary_index=None,
    texts=None,
    use_reranker: bool = True,
    reranker=None,
    use_maxsim: bool = False,
    use_intent: bool = True,
    intent_fast: bool = False,
    use_expansion: bool = True,
    expansion_parallel: bool | None = None,
    retriever_config=None,
    n_candidates: int = 40,
    rerank_top_k: int = 10,
    max_context_chars: int = 32_000,
    enable_dual_generation: bool = False,
    generation_temperature: float = 0.1,
) -> RAGPipeline:
    """Factory wiring the full native pipeline (reference factory
    `create_pipeline` :935-1103, defaults from `configs/config.yaml:48-81`:
    hybrid retrieval on, expansion n=3, rerank 40→10, context 32k chars,
    dual-gen off)."""
    from ..retrieval.retriever import HybridRetriever, RetrieverConfig
    from ..retrieval.reranker import CrossEncoderReranker, MaxSimReranker
    from .expander import QueryExpander

    expander = QueryExpander(llm, parallel=expansion_parallel) \
        if use_expansion else None
    retriever = HybridRetriever(
        index, embedder, bm25_stats=bm25_stats, summary_index=summary_index,
        query_expander=expander, texts=texts,
        config=retriever_config or RetrieverConfig(),
    )
    if use_reranker and reranker is None:
        if use_maxsim:
            # ColBERT late-interaction rerank (BASELINE config 4): needs an
            # index built with colbert vectors (CorpusIndexer with_colbert)
            reranker = MaxSimReranker(index, embedder)
        else:
            # cross-encoder + topic matcher, the reference's default
            # wiring — ONE construction site (default_reranker)
            from ..retrieval.reranker import default_reranker

            reranker = default_reranker(embedder)
    return RAGPipeline(
        retriever=retriever,
        generator=Generator(llm, temperature=generation_temperature),
        context_builder=ContextBuilder(
            llm=llm, max_context_chars=max_context_chars
        ),
        intent_classifier=(IntentClassifier(llm, fast=intent_fast)
                           if use_intent else None),
        reranker=reranker if use_reranker else None,
        relevance_validator=None if use_reranker else RelevanceValidator(),
        n_candidates=n_candidates,
        rerank_top_k=rerank_top_k,
        enable_dual_generation=enable_dual_generation,
    )
