"""Corpus indexer: chunks → device index (TPU batch encode).

Port of `rag_dpo_tpu/ingest/indexer.py`: the index lives on `device`
(default: the embedder's), or row-sharded over `mesh` where one is given. A fresh build takes BM25 stats
and ELL arrays from the C++ ingestion runtime (`native`) wherever the JAX
indexer does, else from the Python path.

Role parity with `src/processing/create_chromadb_index.py`: modes
reset/append/update (:70-130), `heading\\n\\ntext` embedded together
(:322-330, here the chunker already prefixes the heading), the ~20-field
metadata schema (:339-360), and `--verify-only` self-check queries
(:389-486). The encode hot loop runs on TPU in one batched program per
bucket instead of GPU batches of 100; BM25 ELL arrays and optional ColBERT
vectors are built in the same pass (one forward yields all three heads).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
import time
from typing import Iterable, Sequence

import numpy as np

from ..index import DeviceIndex, IndexConfig
from ..providers.embedding import Embedder
from ..retrieval.bm25 import (
    Bm25Stats,
    build_bm25_stats,
    build_ell_corpus_tf,
)
from ..tokenize.french import tokenize_french_text

log = logging.getLogger(__name__)


@dataclasses.dataclass
class IndexerReport:
    n_indexed: int
    n_updated: int
    build_seconds: float
    verification: dict


class CorpusIndexer:
    def __init__(self, embedder: Embedder, ell_width: int = 32,
                 with_colbert: bool = False, colbert_len: int = 0,
                 device=None, mesh=None):
        self.embedder = embedder
        # a fresh index is row-sharded over `mesh` (`DeviceIndex(mesh=)`)
        self.mesh = mesh
        self.ell_width = ell_width
        self.with_colbert = with_colbert
        self.colbert_len = colbert_len
        self.device = (device if device is not None
                       else getattr(embedder, "device", None))

    # -------------------------------------------------------------- build
    def build(
        self,
        chunks: Sequence[dict],
        mode: str = "reset",
        index: DeviceIndex | None = None,
    ) -> tuple[DeviceIndex, Bm25Stats, IndexerReport]:
        """chunks: [{'chunk_id', 'text', 'heading'?, …metadata}].

        mode: reset (new index) | append (add new ids) | update (upsert).
        """
        t0 = time.time()
        assert mode in ("reset", "append", "update")
        texts = [c["text"] for c in chunks]
        ids = [c["chunk_id"] for c in chunks]

        if mode == "append" and index is not None:
            fresh = [i for i, cid in enumerate(ids) if cid not in index]
            chunks = [chunks[i] for i in fresh]
            texts = [texts[i] for i in fresh]
            ids = [ids[i] for i in fresh]

        incremental = index is not None and mode in ("append", "update")
        # incremental: the stored ELL arrays fix the width (a LOCAL
        # override — mutating self would leak the old index's width into
        # later unrelated builds on the same CorpusIndexer)
        width = index.config.ell_width if incremental else self.ell_width
        replaced: list[str] = []
        if incremental and mode == "update":
            replaced = [cid for cid in ids if cid in index]
        stats, terms, impacts, tf, dl = self._build_sparse(
            texts, index if incremental else None, replaced, width
        )

        out = self.embedder.embed(
            texts, return_colbert=self.with_colbert
        )
        dense = out["dense"]

        colbert = None
        if self.with_colbert:
            dc = self.embedder.config.model.colbert_dim
            colbert = np.zeros((len(texts), self.colbert_len, dc),
                               np.float16)
            for i, cb in enumerate(out["colbert"]):
                L = min(len(cb), self.colbert_len)
                colbert[i, :L] = cb[:L]
        # the f32 ColBERT rows are views of whole padded batches (~2x the
        # f16 store at full width): drop them before the store copies it
        del out

        metas = []
        for c in chunks:
            m = {k: v for k, v in c.items() if k != "chunk_id"}
            m.setdefault("word_count", len(c["text"].split()))
            metas.append(m)

        if index is None or mode == "reset":
            index = DeviceIndex(
                IndexConfig(
                    dim=self.embedder.dim, ell_width=self.ell_width,
                    colbert_dim=(self.embedder.config.model.colbert_dim
                                 if self.with_colbert else 0),
                    colbert_len=self.colbert_len,
                ),
                device=None if self.mesh is not None else self.device,
                mesh=self.mesh,
            )
        if incremental:
            # avgdl moved: re-derive every existing row's impacts under
            # the merged stats BEFORE adding the new rows (whose impacts
            # were already computed under the merged stats).
            index.recompute_impacts(stats)
        else:
            index.bm25_stats = stats
        index.add(ids, dense, metas, terms, impacts, colbert=colbert,
                  tf=tf, dl=dl)

        report = IndexerReport(
            n_indexed=len(ids),
            n_updated=len(replaced),
            build_seconds=round(time.time() - t0, 2),
            verification=self.verify(index, texts[:3], ids[:3]),
        )
        log.info("indexed %d chunks in %.1fs", len(ids),
                 report.build_seconds)
        return index, stats, report

    # -------------------------------------------------------------- sparse
    def _build_sparse(self, texts: Sequence[str],
                      existing: DeviceIndex | None,
                      replaced_ids: Sequence[str] = (),
                      width: int | None = None):
        """Tokenize + BM25 stats + ELL arrays for `texts`.

        Fresh build (existing=None): stats come from the new corpus alone
        (C++ runtime when available). Incremental (existing index given):
        the persisted stats are *extended* — same term-id space, df/avgdl
        updated over the full corpus — and the new rows' arrays are
        computed under the merged stats. Returns
        (stats, terms, impacts, tf, dl)."""
        from .. import native
        from ..retrieval.bm25 import (
            extend_bm25_stats,
            impacts_from_tf,
            retract_bm25_stats,
        )

        width = self.ell_width if width is None else width
        if existing is not None:
            base = existing.bm25_stats
            if base is None or base.df is None:
                # legacy checkpoint without persisted stats: rebuild from
                # the full corpus (existing metadata texts + new texts)
                # so the id space is at least self-consistent.
                log.warning(
                    "index has no persisted BM25 stats — rebuilding the "
                    "vocab over the full corpus (legacy checkpoint)"
                )
                old_texts = [
                    str(existing.meta.row(i).get("text", ""))
                    for i in range(existing.n_rows)
                ]
                old_tokens = [tokenize_french_text(t) for t in old_texts]
                base = build_bm25_stats(old_tokens)
                old_terms, old_tf, old_dl = build_ell_corpus_tf(
                    old_tokens, base, width
                )
                existing._terms = old_terms
                existing._tf = old_tf
                existing._dl = old_dl
                existing.bm25_stats = base
            if replaced_ids:
                # update mode: the OLD versions of re-indexed docs leave
                # the corpus — retract their df/length contributions
                # (exact: old texts live in the metadata rows)
                old_texts = [
                    str(existing.meta.row(existing._id_pos[cid])
                        .get("text", ""))
                    for cid in replaced_ids
                ]
                base = retract_bm25_stats(
                    base, [tokenize_french_text(t) for t in old_texts]
                )
            token_lists = [tokenize_french_text(t) for t in texts]
            stats = extend_bm25_stats(base, token_lists)
            terms, tf, dl = build_ell_corpus_tf(token_lists, stats, width)
            return stats, terms, impacts_from_tf(tf, dl, stats), tf, dl

        if native.is_available():
            # C++ ingestion runtime: tokenize + BM25 stats + ELL arrays
            # in one native pass (tests assert bit-level score parity)
            stats, terms, impacts, tf, dl = native.build_ell_corpus_native(
                texts, ell_width=width, return_tf=True
            )
            return stats, terms, impacts, tf, dl
        token_lists = [tokenize_french_text(t) for t in texts]
        stats = build_bm25_stats(token_lists)
        terms, tf, dl = build_ell_corpus_tf(token_lists, stats, width)
        return stats, terms, impacts_from_tf(tf, dl, stats), tf, dl

    # -------------------------------------------------------------- verify
    def verify(self, index: DeviceIndex, probe_texts: Sequence[str],
               probe_ids: Sequence[str]) -> dict:
        """Self-verification: each probe text must retrieve itself top-1;
        plus per-nature/source counts (reference :389-486)."""
        result = {"self_retrieval_ok": True, "probes": []}
        if probe_texts:
            q = self.embedder.embed(list(probe_texts))["dense"]
            _, rows = index.search_dense(q, 1)
            for pid, row in zip(probe_ids, rows[:, 0]):
                got = index.ids[row] if row >= 0 else None
                ok = got == pid
                result["probes"].append({"expected": pid, "got": got})
                result["self_retrieval_ok"] &= ok
        counts: dict[str, int] = {}
        for i in range(index.n_rows):
            if not index._alive[i]:
                continue
            nat = str(index.meta.row(i).get("nature", "?"))
            counts[nat] = counts.get(nat, 0) + 1
        result["by_nature"] = counts
        result["n_live"] = len(index)
        return result


def load_chunks_jsonl(path) -> list[dict]:
    """Read a processed-chunks JSONL file (one chunk object per line —
    the reference's `processed_chunks.jsonl` interchange format)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def write_chunks_jsonl(chunks: Iterable[dict], path):
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for c in chunks:
            f.write(json.dumps(c, ensure_ascii=False) + "\n")
