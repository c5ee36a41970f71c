"""Hybrid multi-query retriever — the reference query recipe on device.

Port of `rag_dpo_tpu/retrieval/retriever.py`; only the RRF call changes,
to the port's `ops.fusion.rrf_fuse` on host tensors.

Pipeline (semantics of `src/rag/retriever.py:156-470`, re-architected):
  1. acronym expansion (host string op)
  2. LLM query expansion → up to 3 reformulations (`query_expander.py`)
  3. summary-BM25 document prefilter → top-40 doc keys (`bm25_index.py:170`)
  4. ONE batched device program over all queries: dense top-k for every
     query arm at once + ELL sparse top-k for every arm at once — where the
     reference loops 4 queries × (embed + HNSW + python BM25) sequentially
     (its own HOT LOOP, SURVEY.md §3.1), this is two kernel dispatches;
  5. weighted RRF fusion on device (`ops.fusion`): k=60, original query ×2,
     expansions ×1, BM25 ×1.5 original / ×0.75 expansions — constants from
     `retriever.py:66-90,209,428-432`;
  6. host-side materialization into RetrievedChunk / doc-level dedup
     (`retriever.py:539-578` URL-normalized) for the non-reranker path.

`retrieve_candidates` (no doc dedup, bigger pool) feeds the reranker, like
`retriever.py:312-470`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Sequence

import numpy as np
import torch

from ..index import DeviceIndex
from ..ops.fusion import rrf_fuse
from ..providers.embedding import Embedder
from ..rag.acronyms import expand_acronyms
from ..utils.profiling import span
from .bm25 import Bm25Stats, SummaryBm25Index
from .types import (
    RetrievedChunk,
    RetrievedDocument,
    normalize_doc_key,
    rebuild_documents_from_ranked_chunks,
)


def _default_nature_weights() -> dict:
    # archived/superseded content: the reference never indexes it at
    # all (src/processing/organize_keep_archive.py moves it out of the
    # corpus); an index that does carry it — incremental updates, or a
    # corpus with deliberate archive twins — demotes it at fusion
    return {"ARCHIVE": 0.5}


# navigation-page markers, the retrieval-time analog of the reference's
# phase-6c purge (src/processing/phase_6c_cleanup.py:36-41 NAV_PATTERNS
# — it DELETES such pages from ChromaDB; we demote rows whose
# title/heading still carry the markers, covering pages that slipped
# the ingest filter)
_NAV_MARKERS = re.compile(
    r"(?i)navigation|informations? g[ée]n[ée]rales|en savoir plus|"
    r"lire la suite|voir aussi|toutes les actualit[ée]s|rechercher|"
    r"affiner la recherche|\d+ r[ée]sultat|page \d+ sur \d+")


@dataclasses.dataclass
class RetrieverConfig:
    n_expansions: int = 3
    rrf_k: int = 60
    weight_original: float = 2.0
    weight_expansion: float = 1.0
    weight_bm25_original: float = 1.5
    weight_bm25_expansion: float = 0.75
    prefilter_top_docs: int = 40
    per_arm_k: int = 40          # candidates fetched per retrieval arm
    use_sparse: bool = True
    use_prefilter: bool = True
    max_query_terms: int = 32
    dense_exact: bool = False    # exact blocked kernel vs approx+refine
    # multiplicative priors on the FUSED (rank-space) score, applied
    # before the final candidate ordering: nature→factor (<1 demotes),
    # plus a factor for rows whose title/heading match navigation
    # markers. Multiplicative keeps the prior scale-free in RRF space.
    nature_weights: dict = dataclasses.field(
        default_factory=_default_nature_weights)
    navigation_weight: float = 0.5
    # fused-pool overfetch before the prior re-sort, so a demoted row
    # frees its slot to the next-best row instead of merely sinking
    # inside the returned pool (reference analog: fetch_multiplier=10,
    # src/rag/retriever.py:117)
    fetch_multiplier: int = 4


class HybridRetriever:
    def __init__(
        self,
        index: DeviceIndex,
        embedder: Embedder,
        bm25_stats: Bm25Stats | None = None,
        summary_index: SummaryBm25Index | None = None,
        query_expander=None,
        config: RetrieverConfig | None = None,
        texts: Sequence[str] | None = None,
    ):
        self.index = index
        self.embedder = embedder
        self.bm25_stats = bm25_stats
        self.summary_index = summary_index
        self.query_expander = query_expander
        self.config = config or RetrieverConfig()
        self._texts = list(texts) if texts is not None else None

    # ------------------------------------------------------------ helpers
    def chunk_text(self, row: int) -> str:
        if self._texts is not None and 0 <= row < len(self._texts):
            return self._texts[row]
        return str(self.index.meta.row(row).get("text", ""))

    def _queries(self, question: str) -> list[str]:
        q0 = expand_acronyms(question)
        if self.query_expander is None:
            return [q0]
        return self.query_expander.expand(q0)

    def _doc_filter(self, question: str, where) -> dict | None:
        if not (self.config.use_prefilter and self.summary_index
                and self.summary_index.doc_keys):
            return where
        keys = self.summary_index.relevant_doc_keys(
            question, self.config.prefilter_top_docs
        )
        if not keys:
            return where
        doc_clause = {"doc_key": {"$in": sorted(keys)}}
        if where:
            return {"$and": [where, doc_clause]}
        return doc_clause

    # ------------------------------------------------------------- public
    def retrieve_candidates(
        self,
        question: str,
        n_candidates: int = 40,
        where: dict | None = None,
    ) -> list[RetrievedChunk]:
        """Raw fused candidate pool for the reranker (no doc dedup). Each
        stage after the expansion is a span: `retrieval.prefilter`,
        `.encode`, `.dense`, `.sparse` and `.fuse`."""
        cfg = self.config
        queries = self._queries(question)
        # prefilter on the ACRONYM-EXPANDED query (queries[0]), like the
        # retrieval arms — summaries spell acronyms out, so filtering on
        # the raw question could $in-mask every relevant document away
        with span("retrieval.prefilter"):
            eff_where = self._doc_filter(queries[0], where)
        nq = len(queries)
        k_arm = cfg.per_arm_k

        # --- dense arms: one batched search over all query variants
        with span("retrieval.encode"):
            q_dense = self.embedder.embed_queries(queries)  # [nq, D]
        with span("retrieval.dense"):
            d_scores, d_rows = self.index.search_dense(
                q_dense, k_arm, where=eff_where, exact=cfg.dense_exact)

        arms = [d_rows[i] for i in range(nq)]
        weights = [cfg.weight_original] + [cfg.weight_expansion] * (nq - 1)

        # --- sparse arms (BM25) batched
        s_rows = None
        if cfg.use_sparse and self.bm25_stats is not None:
            with span("retrieval.sparse"):
                pairs = [self.bm25_stats.query_terms(q, cfg.max_query_terms)
                         for q in queries]
                qt = np.stack([p[0] for p in pairs])
                qw = np.stack([p[1] for p in pairs])
                s_scores, s_rows = self.index.search_sparse(
                    qt, qw, k_arm, where=eff_where
                )
            for i in range(nq):
                arms.append(s_rows[i])
                weights.append(
                    cfg.weight_bm25_original if i == 0
                    else cfg.weight_bm25_expansion
                )

        with span("retrieval.fuse"):
            # --- weighted RRF fusion on the host (a few hundred ids;
            # overfetched: the content prior below may demote rows out of
            # the final pool)
            ids = torch.from_numpy(
                np.stack(arms)[:, None, :].astype(np.int32))  # [A,1,L]
            w = torch.from_numpy(np.asarray(weights, np.float32))
            n_fetch = min(n_candidates * max(cfg.fetch_multiplier, 1),
                          ids.shape[0] * ids.shape[2])
            fused_scores, fused_rows = rrf_fuse(
                ids, w, k_rrf=cfg.rrf_k, topk=n_fetch
            )
            fused_scores = fused_scores[0].numpy()
            fused_rows = fused_rows[0].numpy()

            dense_by_row = {
                int(r): float(s)
                for rr, ss in zip(d_rows, d_scores)
                for r, s in zip(rr, ss) if r >= 0
            }
            sparse_by_row: dict[int, float] = {}
            if s_rows is not None:
                sparse_by_row = {
                    int(r): float(s)
                    for rr, ss in zip(s_rows, s_scores)
                    for r, s in zip(rr, ss) if r >= 0
                }

            out: list[RetrievedChunk] = []
            for row, score in zip(fused_rows, fused_scores):
                if row < 0:
                    continue
                row = int(row)
                meta = dict(self.index.meta.row(row))
                out.append(RetrievedChunk(
                    chunk_id=self.index.ids[row],
                    text=self.chunk_text(row),
                    metadata=meta,
                    score=float(score) * self._content_prior(meta),
                    dense_score=dense_by_row.get(row, 0.0),
                    sparse_score=sparse_by_row.get(row, 0.0),
                    row=row,
                ))
            # the prior can reorder: ≤n_fetch rows, host sort is free; cut
            # back to the requested pool size after demotion
            out.sort(key=lambda c: -c.score)
        return out[:n_candidates]

    def _content_prior(self, meta: dict) -> float:
        """Multiplicative fused-score prior from row metadata: demotes
        archived natures and navigation-marker titles (the retrieval-
        time analog of the reference's corpus-level exclusions — see
        RetrieverConfig.nature_weights)."""
        cfg = self.config
        factor = 1.0
        if cfg.nature_weights:
            factor *= float(cfg.nature_weights.get(
                str(meta.get("nature", "")), 1.0))
        if cfg.navigation_weight != 1.0:
            blob = f"{meta.get('title', '')} {meta.get('heading', '')}"
            if _NAV_MARKERS.search(blob):
                factor *= cfg.navigation_weight
        return factor

    def retrieve(
        self,
        question: str,
        n_documents: int = 5,
        n_chunks_per_doc: int = 3,
        where: dict | None = None,
    ) -> list[RetrievedDocument]:
        """Doc-level retrieval with URL-normalized dedup (non-reranker
        path parity: `retriever.py:156-310,539-578`)."""
        pool = self.retrieve_candidates(
            question, n_candidates=max(40, n_documents * 8), where=where
        )
        return rebuild_documents_from_ranked_chunks(
            pool, n_documents, n_chunks_per_doc
        )
