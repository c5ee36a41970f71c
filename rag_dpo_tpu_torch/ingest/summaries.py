"""Per-document summary sheets ("fiche synthétique") for the BM25
document prefilter.

Role parity with `src/processing/generate_document_summaries.py`: one
structured summary per document, reconstructed from its chunks (:73-90),
prompt shape NATURE/TYPE/SUJETS/USAGE DPO/CONTIENT/NE CONTIENT PAS
(:38-70); navigation-page detection flags documents for cleanup (phase 6c
analog). Output feeds `retrieval.SummaryBm25Index`.
"""

from __future__ import annotations

import json
import pathlib
import re
from typing import Sequence

from ..providers.base import BaseLLMProvider

SUMMARY_PROMPT = """Rédige la fiche synthétique de ce document pour un
délégué à la protection des données. Format STRICT :

NATURE: <DOCTRINE|GUIDE|SANCTION|TECHNIQUE|MIXTE>
TYPE: <type de document>
SUJETS: <3-6 sujets séparés par des virgules>
USAGE DPO: <à quoi sert ce document en pratique>
CONTIENT: <ce qu'on y trouve>
NE CONTIENT PAS: <ce qu'on n'y trouvera pas>

Titre : {title}
Contenu (extraits) :
{content}

Fiche :"""

_NAV_PATTERNS = (
    re.compile(r"^\s*-?\s*(accueil|sommaire|voir aussi|en savoir plus)",
               re.IGNORECASE | re.MULTILINE),
    re.compile(r"(lire la suite\s*){3,}", re.IGNORECASE),
)


def looks_like_navigation(text: str) -> bool:
    """Navigation/hub pages: mostly links, little content."""
    words = text.split()
    if len(words) < 30:
        return True
    link_lines = sum(
        1 for line in text.splitlines()
        if line.strip().startswith("-") and len(line.split()) < 8
    )
    total_lines = max(len([l for l in text.splitlines() if l.strip()]), 1)
    if link_lines / total_lines > 0.7:
        return True
    return any(p.search(text) for p in _NAV_PATTERNS)


VISION_SUMMARY_PROMPT = (
    "Ce document ne contient presque pas de texte extractible "
    "(infographie ou scan). Décris son contenu informatif pour un DPO : "
    "sujets, obligations, acteurs, chiffres visibles. Titre : {title}"
)


class SummaryGenerator:
    def __init__(self, llm: BaseLLMProvider, max_chars: int = 8000,
                 vision_min_chars: int = 500):
        self.llm = llm
        self.max_chars = max_chars
        # below this much extractible text, the document is an
        # infographic/scan → vision summary (reference
        # generate_document_summaries.py:36)
        self.vision_min_chars = vision_min_chars

    def summarize_document(self, title: str,
                           chunk_texts: Sequence[str],
                           raw_bytes: bytes | None = None) -> dict:
        content = "\n\n".join(chunk_texts)[: self.max_chars]
        if len(content) < self.vision_min_chars and raw_bytes is not None \
                and hasattr(self.llm, "generate_with_image"):
            resp = self.llm.generate_with_image(
                VISION_SUMMARY_PROMPT.format(title=title), raw_bytes)
            if getattr(resp, "ok", False) and resp.text.strip():
                return {"title": title, "summary": resp.text.strip(),
                        "navigation": False, "via": "vision"}
        if looks_like_navigation(content):
            return {"title": title, "summary": "", "navigation": True}
        from ..providers.base import background_priority_kwargs

        resp = self.llm.generate(
            SUMMARY_PROMPT.format(title=title, content=content),
            temperature=0.0,
            **background_priority_kwargs(self.llm),
        )
        summary = resp.text.strip() if resp.ok else ""
        return {"title": title, "summary": summary, "navigation": False}

    def run(self, docs: dict[str, dict], out_path,
            resume: bool = True) -> dict:
        """docs: {doc_key: {'title', 'chunks': [text…], 'url'?}} →
        {doc_key: fiche}; checkpointed to out_path after each doc."""
        out_path = pathlib.Path(out_path)
        results: dict[str, dict] = {}
        if resume and out_path.exists():
            results = json.loads(out_path.read_text())
        for doc_key, doc in docs.items():
            if doc_key in results and results[doc_key].get("summary"):
                continue
            raw = None
            path = doc.get("path")
            if path and sum(len(t) for t in doc.get("chunks", [])) \
                    < self.vision_min_chars:
                try:
                    raw = pathlib.Path(path).read_bytes()
                except OSError:
                    raw = None
            fiche = self.summarize_document(
                doc.get("title", doc_key), doc.get("chunks", []),
                raw_bytes=raw,
            )
            fiche["doc_key"] = doc_key
            fiche["url"] = doc.get("url", "")
            results[doc_key] = fiche
            out_path.parent.mkdir(parents=True, exist_ok=True)
            out_path.write_text(
                json.dumps(results, ensure_ascii=False)
            )
        return results
