"""Incremental corpus update (monthly-refresh analog of update_cnil.py).

Flow (reference docstring :1-19): conditional scrape (If-Modified-Since) →
re-filter/re-classify/re-chunk only the CHANGED documents → index update/
append → regenerate missing summaries. Supports dry-run and status.

Port: a copy of `rag_dpo_tpu/ingest/update.py` but for the saved index,
which loads on the embedder's device.
"""

from __future__ import annotations

import json
import logging
import pathlib

from .indexer import CorpusIndexer
from .parsing import parse_document
from .pipeline import IngestPipeline, PipelineContext
from .scraper import Scraper

log = logging.getLogger(__name__)


class IncrementalUpdater:
    def __init__(self, scraper: Scraper, ctx: PipelineContext):
        self.scraper = scraper
        self.ctx = ctx

    def status(self) -> dict:
        visited = self.scraper.state.get("visited", {})
        return {
            "n_known_urls": len(visited),
            "n_failed": len(self.scraper.state.get("failed", [])),
            "index_exists": (self.ctx.paths.index_dir
                             / "manifest.json").exists(),
        }

    def update(self, dry_run: bool = False,
               force_reindex: bool = False) -> dict:
        result = self.scraper.update_existing()
        changed_urls = set(result["changed"])
        if dry_run:
            return {"dry_run": True, **result}

        pipeline = IngestPipeline(self.ctx)
        docs = pipeline._scraped_docs()
        changed_docs = [d for d in docs if d["url"] in changed_urls] \
            if not force_reindex else docs
        if not changed_docs:
            return {"n_changed": 0, **result}

        # re-chunk the changed documents only — but MERGE the whole-corpus
        # artifacts instead of letting the full-pipeline steps overwrite
        # them with just the changed subset (review finding)
        paths = self.ctx.paths
        prior_meta = (json.loads(paths.document_metadata.read_text())
                      if paths.document_metadata.exists() else {})
        prior_chunks = []
        if paths.processed_chunks.exists():
            from .indexer import load_chunks_jsonl

            prior_chunks = load_chunks_jsonl(paths.processed_chunks)

        saved_docs = self.ctx.docs
        self.ctx.docs = changed_docs
        pipeline.step_classify()
        chunk_report = pipeline.step_chunk()
        changed_chunks = self.ctx.chunks
        self.ctx.docs = saved_docs

        changed_keys = {c["doc_key"] for c in changed_chunks}
        merged_meta = dict(prior_meta)
        if paths.document_metadata.exists():
            merged_meta.update(
                json.loads(paths.document_metadata.read_text()))
        paths.document_metadata.write_text(
            json.dumps(merged_meta, ensure_ascii=False))
        merged_chunks = [c for c in prior_chunks
                         if c["doc_key"] not in changed_keys] \
            + changed_chunks
        self.ctx.chunks = merged_chunks
        from .indexer import write_chunks_jsonl

        write_chunks_jsonl(merged_chunks, paths.processed_chunks)

        # upsert into the live index (mode=update)
        from ..index import DeviceIndex

        index = self.ctx.index
        if index is None and (paths.index_dir
                              / "manifest.json").exists():
            index = DeviceIndex.load(
                paths.index_dir,
                device=getattr(self.ctx.embedder, "device", None))
        indexer = CorpusIndexer(self.ctx.embedder)
        index, stats, report = indexer.build(
            changed_chunks, mode="update" if index is not None else "reset",
            index=index,
        )
        # a shrunk document leaves stale chunks beyond the new count:
        # tombstone every indexed chunk of a changed doc that is NOT in
        # its new chunk set (review finding)
        new_ids = {c["chunk_id"] for c in changed_chunks}
        stale = [
            cid for i, cid in enumerate(index.ids)
            if index._alive[i] and cid not in new_ids
            and index.meta.row(i).get("doc_key") in changed_keys
        ]
        if stale:
            index.delete(stale)
        self.ctx.index = index
        self.ctx.bm25_stats = stats
        index.save(paths.index_dir)

        # regenerate summaries for changed docs
        pipeline.step_summaries()
        return {
            "n_changed": len(changed_docs),
            "n_chunks_updated": chunk_report["n_chunks"],
            "n_stale_purged": len(stale),
            **result,
        }
