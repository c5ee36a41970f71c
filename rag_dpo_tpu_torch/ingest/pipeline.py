"""Corpus build pipeline runner: declarative steps, resume, dry-check.

Role parity with `rebuild_pipeline.py`: a declarative step registry (:33-96)
executed in order ['filter', 'organize', 'dedup', 'classify', 'chunk',
'index', 'summaries', 'cleanup', 'tag'] with --from/--only/--steps/--check
semantics (:98-120) — the reference's phase codes 3→6d map 1:1 onto these
names. Design difference: steps are in-process callables over a shared
`PipelineContext` (not subprocesses) so state flows typed instead of
through intermediate files only; every step still persists its artifact so
interrupted runs resume.

Port: a copy of `rag_dpo_tpu/ingest/pipeline.py` but for `_ensure_index`,
which loads a saved index on the embedder's device (the port's
`DeviceIndex.load` takes the card when given none).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
import time
from typing import Callable

from ..utils.paths import Paths
from .chunker import StructuralChunker
from .classify import ChunkClassifier, DocumentClassifier
from .dedup import deduplicate
from .filter import RelevanceFilter
from .indexer import CorpusIndexer, write_chunks_jsonl
from .parsing import parse_document
from .summaries import SummaryGenerator
from .tagging import ChunkTagger

log = logging.getLogger(__name__)

STEP_ORDER = ["filter", "organize", "dedup", "classify", "chunk",
              "index", "summaries", "cleanup", "tag"]


@dataclasses.dataclass
class PipelineContext:
    paths: Paths
    llm: object
    embedder: object
    docs: list[dict] = dataclasses.field(default_factory=list)
    chunks: list[dict] = dataclasses.field(default_factory=list)
    index: object = None
    bm25_stats: object = None
    summaries: dict = dataclasses.field(default_factory=dict)
    reports: dict = dataclasses.field(default_factory=dict)


class IngestPipeline:
    def __init__(self, ctx: PipelineContext,
                 chunker: StructuralChunker | None = None,
                 test_limit: int | None = None):
        self.ctx = ctx
        self.chunker = chunker or StructuralChunker(llm=ctx.llm)
        self.test_limit = test_limit
        self.steps: dict[str, Callable[[], dict]] = {
            "filter": self.step_filter,
            "organize": self.step_organize,
            "dedup": self.step_dedup,
            "classify": self.step_classify,
            "chunk": self.step_chunk,
            "index": self.step_index,
            "summaries": self.step_summaries,
            "cleanup": self.step_cleanup,
            "tag": self.step_tag,
        }

    # ------------------------------------------------------------- driver
    def run(self, from_step: str | None = None,
            only: str | None = None,
            steps: list[str] | None = None,
            check: bool = False) -> dict:
        if only:
            selected = [only]
        elif steps:
            selected = [s for s in STEP_ORDER if s in steps]
        elif from_step:
            selected = STEP_ORDER[STEP_ORDER.index(from_step):]
        else:
            selected = list(STEP_ORDER)
        if check:
            return {"would_run": selected}
        for name in selected:
            t0 = time.time()
            log.info("pipeline step %s …", name)
            report = self.steps[name]()
            report["seconds"] = round(time.time() - t0, 2)
            self.ctx.reports[name] = report
            log.info("pipeline step %s done: %s", name, report)
        return self.ctx.reports

    # --------------------------------------------------------- resume IO
    # Every step persists its artifact; resuming `--from STEP` in a fresh
    # process must RELOAD upstream artifacts instead of running on empty
    # context and clobbering completed outputs (review finding).
    def _ensure_docs(self):
        if self.ctx.docs:
            return
        paths = self.ctx.paths
        if paths.keep_manifest.exists():
            self.ctx.docs = json.loads(paths.keep_manifest.read_text())
        else:
            kept_path = paths.data / "hybrid_classification.json"
            docs = self._scraped_docs()
            if kept_path.exists():
                kept = set(json.loads(kept_path.read_text())["kept"])
                docs = [d for d in docs if d["doc_id"] in kept]
            self.ctx.docs = docs
        if paths.document_metadata.exists():  # overlay classify fields
            meta = json.loads(paths.document_metadata.read_text())
            for d in self.ctx.docs:
                d.update({k: v for k, v in
                          meta.get(d["doc_id"], {}).items()
                          if v is not None})
        if self.test_limit:
            self.ctx.docs = self.ctx.docs[: self.test_limit]

    def _ensure_chunks(self):
        if not self.ctx.chunks and self.ctx.paths.processed_chunks.exists():
            from .indexer import load_chunks_jsonl

            self.ctx.chunks = load_chunks_jsonl(
                self.ctx.paths.processed_chunks)

    def _ensure_index(self):
        if self.ctx.index is None and (
                self.ctx.paths.index_dir / "manifest.json").exists():
            from ..index import DeviceIndex

            self.ctx.index = DeviceIndex.load(
                self.ctx.paths.index_dir,
                device=getattr(self.ctx.embedder, "device", None))
            self.ctx.bm25_stats = self.ctx.index.bm25_stats

    def _ensure_summaries(self):
        if not self.ctx.summaries and \
                self.ctx.paths.document_summaries.exists():
            self.ctx.summaries = json.loads(
                self.ctx.paths.document_summaries.read_text())

    # -------------------------------------------------------------- steps
    def _scraped_docs(self) -> list[dict]:
        """Load scraped raw docs ({url, title, path|content})."""
        docs = []
        raw = self.ctx.paths.raw
        for meta_file in sorted(raw.rglob("*.meta.json")):
            meta = json.loads(meta_file.read_text())
            content_path = pathlib.Path(meta["path"])
            if not content_path.exists():
                continue
            docs.append({
                "doc_id": content_path.stem,
                "url": meta.get("url", ""),
                "kind": meta.get("kind", "html"),
                "path": str(content_path),
            })
        if self.test_limit:
            docs = docs[: self.test_limit]
        return docs

    def step_filter(self) -> dict:
        relevance = RelevanceFilter(llm=self.ctx.llm)
        kept, dropped = [], 0
        for doc in self._scraped_docs():
            if doc["kind"] != "html":
                kept.append(doc)  # binaries judged at classify time
                continue
            data = pathlib.Path(doc["path"]).read_bytes()
            sections = parse_document(data, "html")
            text = "\n".join(s.text for s in sections)[:5000]
            title = sections[0].heading if sections else ""
            decision = relevance.decide(doc["url"], title, text)
            if decision.keep:
                doc["title"] = title
                kept.append(doc)
            else:
                dropped += 1
        self.ctx.docs = kept
        out = self.ctx.paths.data / "hybrid_classification.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"kept": [d["doc_id"] for d in kept], "n_dropped": dropped}
        ))
        return {"n_kept": len(kept), "n_dropped": dropped}

    def step_organize(self) -> dict:
        """Keep-manifest emission (size floors like organize_keep_archive:
        tiny PDFs / decorative images excluded)."""
        self._ensure_docs()
        manifest = []
        for doc in self.ctx.docs:
            size = pathlib.Path(doc["path"]).stat().st_size
            if doc["kind"] == "pdf" and size < 3 * 1024:
                continue
            if doc["kind"] == "image" and size < 476 * 1024:
                continue
            manifest.append(doc)
        self.ctx.docs = manifest
        self.ctx.paths.keep_manifest.parent.mkdir(parents=True,
                                                  exist_ok=True)
        self.ctx.paths.keep_manifest.write_text(
            json.dumps(manifest, ensure_ascii=False)
        )
        return {"n_manifest": len(manifest)}

    def step_dedup(self) -> dict:
        self._ensure_docs()
        docs = []
        for doc in self.ctx.docs:
            data = pathlib.Path(doc["path"]).read_bytes()
            if doc["kind"] == "html":
                sections = parse_document(data, "html")
                content = "\n".join(s.text for s in sections)
            else:
                content = data
            docs.append({**doc, "content": content})
        kept, archived = deduplicate(docs)
        for d in kept:
            d.pop("content", None)
        self.ctx.docs = kept
        return {"n_kept": len(kept), "n_duplicates": len(archived)}

    def step_classify(self) -> dict:
        self._ensure_docs()
        cache_path = self.ctx.paths.data / "doc_classify_cache.json"
        cache = (json.loads(cache_path.read_text())
                 if cache_path.exists() else {})
        classifier = DocumentClassifier(self.ctx.llm, cache=cache)
        for doc in self.ctx.docs:
            if doc["kind"] != "html":
                continue
            data = pathlib.Path(doc["path"]).read_bytes()
            sections = parse_document(data, "html")
            text = "\n".join(s.text for s in sections)
            c = classifier.classify(doc["doc_id"],
                                    doc.get("title", ""), text)
            doc["nature"] = c.nature
            doc["sectors"] = c.secteurs
            doc["importance"] = c.importance
        cache_path.write_text(json.dumps(cache, ensure_ascii=False))
        self.ctx.paths.document_metadata.write_text(json.dumps(
            {d["doc_id"]: {k: d.get(k) for k in
                           ("nature", "sectors", "importance", "url",
                            "title")}
             for d in self.ctx.docs}, ensure_ascii=False,
        ))
        return {"n_classified": len(self.ctx.docs)}

    def _pdf_vision(self):
        """Infographic-PDF fallback: hand pages with no text layer to the
        vision-capable LLM (reference `process_and_chunk.py:413-516`)."""
        llm = self.ctx.llm
        if llm is None or not hasattr(llm, "generate_with_image"):
            return None

        def describe(pdf_bytes: bytes, page_index: int) -> str:
            # the whole document ships with a page hint (no rasterizer on
            # this host); page-aware providers focus on it, others return
            # one description that parse_pdf deduplicates across pages
            resp = llm.generate_with_image(
                f"Décris précisément le contenu informatif de la page "
                f"{page_index + 1} de ce document (schéma, infographie "
                "ou tableau) en français : acteurs, flux, obligations, "
                "chiffres. Ignore la décoration.",
                pdf_bytes,
            )
            return resp.text if getattr(resp, "ok", False) else ""

        return describe

    def _image_sections(self, doc: dict, data: bytes) -> list:
        """Informative images (schemas/infographics kept by phase 4B)
        become ONE vision-described section; without a vision-capable
        LLM the image is skipped, never decoded as text."""
        from .parsing import Section

        llm = self.ctx.llm
        if llm is None or not hasattr(llm, "generate_with_image"):
            return []
        resp = llm.generate_with_image(
            "Décris le contenu informatif de cette image (schéma ou "
            "infographie RGPD) en français : acteurs, flux, obligations, "
            "chiffres. Ignore la décoration.", data)
        if not getattr(resp, "ok", False) or not resp.text.strip():
            return []
        return [Section(heading=doc.get("title", ""),
                        text=resp.text.strip(), level=0,
                        page_info="image (vision)")]

    def step_chunk(self) -> dict:
        self._ensure_docs()
        chunk_classifier = ChunkClassifier(llm=self.ctx.llm)
        vision = self._pdf_vision()
        all_chunks: list[dict] = []
        for doc in self.ctx.docs:
            data = pathlib.Path(doc["path"]).read_bytes()
            if doc["kind"] == "image":
                # NEVER decode binary image bytes as text (that indexed
                # UTF-8 replacement noise — review finding): describe
                # through the vision LLM, or drop when none is available
                sections = self._image_sections(doc, data)
                if not sections:
                    continue
            else:
                try:
                    sections = parse_document(data, doc["kind"],
                                              vision=vision)
                except ValueError:
                    continue
            for chunk in self.chunker.chunk_sections(sections,
                                                     doc["doc_id"]):
                nature = chunk_classifier.classify(chunk.body,
                                                   chunk.features)
                all_chunks.append({
                    "chunk_id": chunk.chunk_id,
                    "text": chunk.text,
                    "heading": chunk.heading,
                    "page_info": chunk.page_info,
                    "nature": nature,
                    "natures": [nature],
                    "doc_nature": doc.get("nature", ""),
                    "sectors": doc.get("sectors", []),
                    "importance": doc.get("importance", 5),
                    "doc_key": doc["doc_id"],
                    "source_url": doc.get("url", ""),
                    "title": doc.get("title", ""),
                    "source": "CNIL",
                    "file_type": doc["kind"],
                    "word_count": chunk.features.get("word_count", 0),
                })
        self.ctx.chunks = all_chunks
        if all_chunks or not self.ctx.paths.processed_chunks.exists():
            write_chunks_jsonl(all_chunks,
                               self.ctx.paths.processed_chunks)
        else:  # zero chunks produced: never clobber a completed artifact
            log.warning("step_chunk produced 0 chunks — keeping the "
                        "existing processed_chunks.jsonl")
        return {
            "n_chunks": len(all_chunks),
            "llm_classify_rate": round(
                chunk_classifier.n_llm_calls
                / max(chunk_classifier.n_total, 1), 3,
            ),
        }

    def step_index(self) -> dict:
        self._ensure_chunks()
        indexer = CorpusIndexer(self.ctx.embedder)
        index, stats, report = indexer.build(self.ctx.chunks, mode="reset")
        self.ctx.index = index
        self.ctx.bm25_stats = stats
        index.save(self.ctx.paths.index_dir)
        return {
            "n_indexed": report.n_indexed,
            "build_seconds": report.build_seconds,
            "verification": report.verification,
        }

    def step_summaries(self) -> dict:
        self._ensure_chunks()
        self._ensure_docs()
        paths_by_doc = {d["doc_id"]: d.get("path")
                        for d in (self.ctx.docs or [])}
        by_doc: dict[str, dict] = {}
        for c in self.ctx.chunks:
            entry = by_doc.setdefault(c["doc_key"], {
                "title": c.get("title", ""),
                "url": c.get("source_url", ""),
                # raw file path: near-textless docs get a vision summary
                "path": paths_by_doc.get(c["doc_key"]),
                "chunks": [],
            })
            entry["chunks"].append(c["text"])
        gen = SummaryGenerator(self.ctx.llm)
        self.ctx.summaries = gen.run(by_doc,
                                     self.ctx.paths.document_summaries)
        return {"n_summaries": len(self.ctx.summaries)}

    def step_cleanup(self) -> dict:
        """Purge navigation pages flagged during summarization (phase 6c
        analog)."""
        self._ensure_summaries()
        self._ensure_chunks()
        self._ensure_index()
        nav_docs = {k for k, v in self.ctx.summaries.items()
                    if v.get("navigation")}
        if not nav_docs or self.ctx.index is None:
            return {"n_purged": 0}
        to_delete = [
            cid for i, cid in enumerate(self.ctx.index.ids)
            if self.ctx.index.meta.row(i).get("doc_key") in nav_docs
        ]
        self.ctx.index.delete(to_delete)
        self.ctx.index.save(self.ctx.paths.index_dir)  # persist purges
        self.ctx.chunks = [c for c in self.ctx.chunks
                           if c["doc_key"] not in nav_docs]
        write_chunks_jsonl(self.ctx.chunks,
                           self.ctx.paths.processed_chunks)
        return {"n_purged": len(to_delete), "n_nav_docs": len(nav_docs)}

    def step_tag(self) -> dict:
        self._ensure_index()
        self._ensure_chunks()
        if self.ctx.index is None:
            return {"n_tagged": 0}
        tagger = ChunkTagger(
            self.ctx.llm,
            checkpoint_path=self.ctx.paths.tasks / "_tag_checkpoint.json",
        )
        texts = {c["chunk_id"]: c["text"] for c in self.ctx.chunks}
        n = tagger.tag_index(self.ctx.index, texts)
        self.ctx.index.save(self.ctx.paths.index_dir)
        return {"n_tagged": n}
