"""Structure-aware chunking with feature extraction and table conversion.

Role parity with the reference's `StructuralChunker` / post-processing in
`src/processing/process_and_chunk.py`:

* sections → chunks split at sentence boundaries when > max_words (600)
  with overlap (50 words), small chunks (<100 words) merged (:973-1098);
* the heading is prefixed into the chunk text so it participates in the
  embedding (:1024-1034);
* tables are converted to natural French sentences by an LLM with [TAGS]
  extraction and a mechanical serialization fallback (:748-859) — the SAME
  conversion serving HTML/PDF/DOCX/XLSX tables (README "content-based"
  table handling);
* regex feature extraction per chunk: article refs, step markers,
  templates, sanctions, technical markers, sectors (:41-90).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

from ..providers.base import BaseLLMProvider
from .parsing import Section, Table

_SENTENCE_SPLIT = re.compile(r"(?<=[.!?;])\s+(?=[A-ZÀ-Ý«\d])")


@dataclasses.dataclass
class ChunkerConfig:
    max_words: int = 600
    min_words: int = 100
    overlap_words: int = 50
    table_llm: bool = True


@dataclasses.dataclass
class Chunk:
    chunk_id: str
    text: str                 # heading-prefixed, embedding-ready
    heading: str
    body: str                 # text without the heading prefix
    page_info: str = ""
    features: dict = dataclasses.field(default_factory=dict)
    tags: list[str] = dataclasses.field(default_factory=list)


class ChunkFeatureExtractor:
    """Regex features used by the rule-based chunk classifier."""

    _PATTERNS = {
        "has_article_refs": re.compile(
            r"\barticles?\s+\d+|\bart\.\s*\d+", re.IGNORECASE),
        "has_steps": re.compile(
            r"\bétapes?\s+\d|^\s*\d+[.)]\s+\w|\bphase\s+\d",
            re.IGNORECASE | re.MULTILINE),
        "has_template": re.compile(
            r"\bmodèle\b|\bexemple de\b|\btrame\b|\bformulaire\b",
            re.IGNORECASE),
        "has_sanctions": re.compile(
            r"\bamende\b|\bsanction\b|\bmise en demeure\b|\bdélibération "
            r"san\b", re.IGNORECASE),
        "has_technical": re.compile(
            r"\bchiffrement\b|\bpseudonymisation\b|\bjournalisation\b|"
            r"\bTLS\b|\bmot de passe\b|\bsauvegarde\b", re.IGNORECASE),
        "has_obligations": re.compile(
            r"\bdoit\b|\bobligatoire\b|\best tenu de\b|\bimpose\b",
            re.IGNORECASE),
        "has_amounts": re.compile(r"\d+\s*(?:€|euros?|M€|millions)",
                                  re.IGNORECASE),
    }
    _SECTORS = ("santé", "banque", "assurance", "éducation", "commerce",
                "collectivité", "association", "ressources humaines")

    def extract(self, text: str) -> dict:
        out = {name: bool(rx.search(text))
               for name, rx in self._PATTERNS.items()}
        low = text.lower()
        out["sectors"] = [s for s in self._SECTORS if s in low]
        out["word_count"] = len(text.split())
        return out


TABLE_PROMPT = """Convertis ce tableau en phrases françaises naturelles et
fidèles, une phrase par ligne de données. Termine par une ligne
[TAGS] mot-clé1, mot-clé2, mot-clé3

Tableau (en-têtes puis lignes, cellules séparées par |) :
{table}

Phrases :"""


def table_to_text(table: Table, llm: BaseLLMProvider | None = None) -> str:
    """LLM natural-French conversion with mechanical fallback."""
    serialized = " | ".join(table.headers) + "\n" + "\n".join(
        " | ".join(row) for row in table.rows[:50]
    )
    if llm is not None:
        resp = llm.generate(TABLE_PROMPT.format(table=serialized),
                            temperature=0.0)
        if resp.ok and len(resp.text.strip()) > 20:
            return resp.text.strip()
    # mechanical fallback: 'header: value' pairs per row
    lines = []
    for row in table.rows:
        pairs = [
            f"{h}: {v}" for h, v in zip(table.headers, row) if v.strip()
        ]
        if pairs:
            lines.append("; ".join(pairs) + ".")
    return "\n".join(lines)


class StructuralChunker:
    def __init__(self, config: ChunkerConfig | None = None,
                 llm: BaseLLMProvider | None = None):
        self.config = config or ChunkerConfig()
        self.llm = llm
        self.features = ChunkFeatureExtractor()

    # ------------------------------------------------------------ public
    def chunk_sections(self, sections: Sequence[Section],
                       doc_id: str) -> list[Chunk]:
        cfg = self.config
        pieces: list[tuple[str, str, str]] = []  # (heading, body, page)
        for sec in sections:
            body = sec.text or ""
            for table in sec.tables:
                converted = table_to_text(
                    table, self.llm if cfg.table_llm else None
                )
                tags_match = re.search(r"\[TAGS\]\s*(.+)", converted)
                if tags_match:
                    converted = converted[: tags_match.start()].strip()
                body = (body + "\n\n" + converted).strip()
            if not body:
                continue
            for part in self._split(body):
                pieces.append((sec.heading, part, sec.page_info))

        pieces = self._merge_small(pieces)

        chunks = []
        for i, (heading, body, page) in enumerate(pieces):
            text = f"[{heading}]\n{body}" if heading else body
            chunks.append(Chunk(
                chunk_id=f"{doc_id}#c{i:04d}",
                text=text,
                heading=heading,
                body=body,
                page_info=page,
                features=self.features.extract(body),
            ))
        return chunks

    # ----------------------------------------------------------- helpers
    def _split(self, body: str) -> list[str]:
        cfg = self.config
        words = body.split()
        if len(words) <= cfg.max_words:
            return [body]
        sentences = _SENTENCE_SPLIT.split(body)
        parts: list[str] = []
        cur: list[str] = []
        n = 0
        for sent in sentences:
            sw = len(sent.split())
            if cur and n + sw > cfg.max_words:
                parts.append(" ".join(cur))
                # sentence overlap tail
                tail_words = " ".join(cur).split()[-cfg.overlap_words:]
                cur = [" ".join(tail_words), sent]
                n = len(tail_words) + sw
            else:
                cur.append(sent)
                n += sw
        if cur:
            parts.append(" ".join(cur))
        return parts

    def _merge_small(self, pieces):
        cfg = self.config
        merged: list[tuple[str, str, str]] = []
        for heading, body, page in pieces:
            if (merged and len(body.split()) < cfg.min_words
                    and merged[-1][0] == heading
                    # never grow an already-full piece: chains of small
                    # merges would compound past any size bound (a small
                    # trailing chunk beats an oversized one)
                    and len(merged[-1][1].split()) < cfg.max_words):
                ph, pb, pp = merged[-1]
                merged[-1] = (ph, pb + "\n" + body, pp)
            else:
                merged.append((heading, body, page))
        # leading tiny piece: merge forward
        if (len(merged) >= 2
                and len(merged[0][1].split()) < cfg.min_words
                and merged[0][0] == merged[1][0]):
            h, b, p = merged[1]
            merged = [(h, merged[0][1] + "\n" + b, merged[0][2])] \
                + merged[2:]
        return merged
