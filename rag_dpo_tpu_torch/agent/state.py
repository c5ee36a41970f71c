"""Agent state — the record threaded through the explicit state machine.

The reference uses a LangGraph TypedDict state; here the graph is a small
explicit state machine (SURVEY.md §7: "the graph is static with 3
conditional edges — no LangGraph dependency needed"), so the state is a
plain mutable dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..rag.intent import QuestionIntent


@dataclasses.dataclass
class AgentState:
    question: str
    original_question: str = ""
    conversation_history: list[dict] = dataclasses.field(default_factory=list)
    where_filter: dict | None = None
    enterprise_tags: list[str] = dataclasses.field(default_factory=list)
    n_documents: int = 5
    n_chunks_per_doc: int = 3
    temperature: float | None = None

    # classify
    intent: QuestionIntent = dataclasses.field(default_factory=QuestionIntent)
    refusal_type: str | None = None

    # enrich
    detected_articles: list[dict] = dataclasses.field(default_factory=list)
    detected_deadlines: list[Any] = dataclasses.field(default_factory=list)
    guard_negative_topics: list[str] = dataclasses.field(default_factory=list)

    # decompose
    sub_questions: list[str] = dataclasses.field(default_factory=list)

    # retrieve
    documents: list = dataclasses.field(default_factory=list)
    n_candidates: int = 0
    retrieval_query: str | None = None   # targeted re-retrieval query
    # candidates fetched concurrently with classify/decompose
    # (nodes.overlap_prepare) — consumed by the first retrieve() when
    # the retrieval query is still the plain question
    prefetched_candidates: list | None = None

    # generate
    answer: str = ""
    built_sources: list[dict] = dataclasses.field(default_factory=list)
    context_text: str = ""
    model: str = ""

    # validate / loops
    grounding_issues: list[str] = dataclasses.field(default_factory=list)
    grounded: bool = True
    generation_retries: int = 0
    re_retrievals: int = 0
    coverage_pct: int = 100

    # streaming: called with each answer text delta as the generate node
    # produces it; called with None to signal that a NEW attempt replaces
    # the streamed draft (grounding retry / re-retrieval regeneration)
    on_delta: Any = None

    # bookkeeping
    timings: dict[str, float] = dataclasses.field(default_factory=dict)
    node_trace: list[str] = dataclasses.field(default_factory=list)
    error: str | None = None

    def record(self, node: str, sp):
        """The node ran, in the span `sp`: its time adds to the node's."""
        self.node_trace.append(node)
        self.timings[node] = self.timings.get(node, 0.0) + sp.seconds
