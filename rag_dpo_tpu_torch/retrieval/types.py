"""Retrieval result containers.

Mirror the information surface of the reference's `RetrievedChunk` /
`RetrievedDocument` (`src/rag/retriever.py:22-63`) so downstream context
building and citation renumbering have the same fields to work with.
Scores here are raw similarities (higher = better); `similarity_score`
keeps the reference's 1/(1+distance) convention for UI parity where
distance-like values exist.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class RetrievedChunk:
    chunk_id: str
    text: str
    metadata: dict[str, Any]
    score: float                    # fused/rerank score, higher = better
    dense_score: float = 0.0
    sparse_score: float = 0.0
    rerank_score: float | None = None
    row: int = -1                   # index row

    @property
    def heading(self) -> str:
        return str(self.metadata.get("heading", "") or "")

    @property
    def source_url(self) -> str:
        return str(
            self.metadata.get("source_url")
            or self.metadata.get("parent_url")
            or ""
        )

    @property
    def title(self) -> str:
        return str(self.metadata.get("title", "") or "")

    @property
    def similarity_score(self) -> float:
        return self.score


@dataclasses.dataclass
class RetrievedDocument:
    doc_key: str                    # normalized source URL / path
    title: str
    chunks: list[RetrievedChunk]
    score: float

    @property
    def best_chunk(self) -> RetrievedChunk:
        return max(self.chunks, key=lambda c: c.score)


def normalize_doc_key(url: str) -> str:
    """URL normalization for doc-level dedup (reference dedups retrieved
    chunks by normalized URL, `retriever.py:539-578`)."""
    url = url.strip().lower()
    for prefix in ("https://", "http://", "www."):
        if url.startswith(prefix):
            url = url[len(prefix):]
    return url.rstrip("/")


def rebuild_documents_from_ranked_chunks(
    chunks: list[RetrievedChunk],
    n_documents: int,
    n_chunks_per_doc: int,
) -> list[RetrievedDocument]:
    """Group ranked chunks back into documents preserving rank order
    (reference `_rebuild_documents_from_ranked_chunks` :805-879) — the
    ONE doc-grouping/dedup implementation, shared by the retriever's
    non-reranker path, the sequential pipeline and the agent."""
    docs: dict[str, list[RetrievedChunk]] = {}
    order: list[str] = []
    for chunk in chunks:
        key = normalize_doc_key(chunk.source_url or chunk.chunk_id)
        if key not in docs:
            docs[key] = []
            order.append(key)
        if len(docs[key]) < n_chunks_per_doc:
            docs[key].append(chunk)
    out = []
    for key in order[:n_documents]:
        group = docs[key]
        out.append(RetrievedDocument(
            doc_key=key,
            title=group[0].title or key,
            chunks=group,
            score=max(c.score for c in group),
        ))
    return out
