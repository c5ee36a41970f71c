"""Enterprise document ingestion into the shared index.

Role parity with `ingest_enterprise.py`: DPO-uploaded internal documents
land in the SAME index as the CNIL corpus with `source="ENTERPRISE"`,
SHA256-derived ids (`ent_<hash>`, :49-60), boolean `tag_<name>` metadata
fields enabling the native `$or` tag filter (`pipeline.py:35-71`), and a
self-maintaining tag registry (configs/enterprise_tags.json). list/purge/
stats management mirrors the reference CLI.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import re
from typing import Sequence

import numpy as np

from .chunker import StructuralChunker
from .parsing import parse_document
from ..retrieval.bm25 import build_ell_corpus
from ..tokenize.french import tokenize_french_text


def _slug(tag: str) -> str:
    return re.sub(r"[^a-z0-9_]+", "_", tag.strip().lower()).strip("_")


class TagRegistry:
    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.tags: list[str] = []
        if self.path.exists():
            self.tags = json.loads(self.path.read_text()).get("tags", [])

    def ensure(self, tags: Sequence[str]) -> list[str]:
        slugs = []
        for tag in tags:
            s = _slug(tag)
            if s and s not in self.tags:
                self.tags.append(s)
            if s:
                slugs.append(s)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps({"tags": self.tags},
                                        ensure_ascii=False))
        return slugs


class EnterpriseIngestor:
    def __init__(self, index, embedder, bm25_stats, tag_registry: TagRegistry,
                 chunker: StructuralChunker | None = None):
        self.index = index
        self.embedder = embedder
        self.bm25_stats = bm25_stats
        self.tags = tag_registry
        self.chunker = chunker or StructuralChunker()

    def ingest(self, file_path, tags: Sequence[str],
               title: str | None = None, fmt: str | None = None) -> dict:
        path = pathlib.Path(file_path)
        data = path.read_bytes()
        doc_hash = hashlib.sha256(data).hexdigest()[:16]
        doc_id = f"ent_{doc_hash}"
        title = title or path.stem

        sections = parse_document(data, fmt or path.suffix.lstrip("."))
        chunks = self.chunker.chunk_sections(sections, doc_id)
        if not chunks:
            return {"doc_id": doc_id, "n_chunks": 0}

        slugs = self.tags.ensure(tags)
        texts = [c.text for c in chunks]
        dense = self.embedder.embed(texts)["dense"]
        token_lists = [tokenize_french_text(t) for t in texts]
        tf = dl = None
        if self.bm25_stats is not None and self.bm25_stats.df is not None:
            # extend the corpus stats (same term-id space) so enterprise
            # docs' terms — often absent from the CNIL vocab — are
            # scoreable, and refresh every row's impacts under the new
            # avgdl (same incremental-consistency rule as the indexer).
            # The update happens IN PLACE on the shared stats object, so
            # retrievers built before this ingest see the new vocabulary.
            from ..retrieval.bm25 import (
                build_ell_corpus_tf,
                extend_bm25_stats,
                impacts_from_tf,
                retract_bm25_stats,
                update_stats_in_place,
            )

            base = self.bm25_stats
            old_texts = self._existing_texts(chunks)
            if old_texts:
                # re-ingest of the same document (same content hash →
                # same chunk ids, upserted in place): retract the OLD
                # versions' df/length contributions first, or repeated
                # uploads double-count the document forever
                base = retract_bm25_stats(
                    base, [tokenize_french_text(t) for t in old_texts]
                )
            merged = extend_bm25_stats(base, token_lists)
            update_stats_in_place(self.bm25_stats, merged)
            terms, tf, dl = build_ell_corpus_tf(
                token_lists, self.bm25_stats, self.index.config.ell_width
            )
            impacts = impacts_from_tf(tf, dl, self.bm25_stats)
            self.index.recompute_impacts(self.bm25_stats)
        elif self.bm25_stats is not None:
            # legacy stats without df: OOV terms drop, ids stay valid
            terms, impacts = build_ell_corpus(
                token_lists, self.bm25_stats, self.index.config.ell_width
            )
        else:
            # hybrid retrieval disabled (retrieval.hybrid=false →
            # bootstrap leaves bm25_stats=None): ingest dense-only —
            # the sparse arm never runs, so empty term rows are correct
            n, w = len(chunks), self.index.config.ell_width
            terms = np.full((n, w), -1, np.int32)
            impacts = np.zeros((n, w), np.float32)
        metas = []
        for c in chunks:
            m = {
                "text": c.text,
                "heading": c.heading,
                "title": title,
                "source": "ENTERPRISE",
                "doc_key": doc_id,
                "source_url": f"enterprise://{path.name}",
                "file_type": (fmt or path.suffix.lstrip(".")).lower(),
            }
            for s in slugs:
                m[f"tag_{s}"] = True
            metas.append(m)
        self.index.add([c.chunk_id for c in chunks], dense, metas,
                       terms, impacts, tf=tf, dl=dl)
        return {"doc_id": doc_id, "n_chunks": len(chunks), "tags": slugs}

    def _existing_texts(self, chunks) -> list[str]:
        """Texts of chunks about to be UPSERTED (ids already live in the
        index) — their old stats contributions must retract first."""
        out = []
        for c in chunks:
            pos = self.index._id_pos.get(c.chunk_id)
            if pos is not None and self.index._alive[pos]:
                out.append(str(self.index.meta.row(pos).get("text", "")))
        return out

    # ------------------------------------------------------- management
    def list_documents(self) -> list[dict]:
        docs: dict[str, dict] = {}
        for i in range(self.index.n_rows):
            if not self.index._alive[i]:
                continue
            meta = self.index.meta.row(i)
            if meta.get("source") != "ENTERPRISE":
                continue
            key = meta.get("doc_key", "?")
            entry = docs.setdefault(key, {
                "doc_id": key, "title": meta.get("title", ""),
                "n_chunks": 0,
                "tags": [k[4:] for k in meta if k.startswith("tag_")],
            })
            entry["n_chunks"] += 1
        return list(docs.values())

    def purge(self, doc_id: str | None = None) -> int:
        to_delete = []
        for i, cid in enumerate(self.index.ids):
            if not self.index._alive[i]:
                continue
            meta = self.index.meta.row(i)
            if meta.get("source") != "ENTERPRISE":
                continue
            if doc_id is None or meta.get("doc_key") == doc_id:
                to_delete.append(cid)
        self.index.delete(to_delete)
        return len(to_delete)

    def stats(self) -> dict:
        docs = self.list_documents()
        return {
            "n_documents": len(docs),
            "n_chunks": sum(d["n_chunks"] for d in docs),
            "tags": self.tags.tags,
        }
