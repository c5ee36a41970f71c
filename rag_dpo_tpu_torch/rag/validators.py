"""Response validation: relevance filtering + deterministic grounding checks.

Role parity with `src/rag/validators.py`:

* RelevanceValidator — pure score-threshold chunk filter (the reference's
  is distance ≤ 0.80 despite its docstring claiming an LLM, :19-81; ours
  works on similarity scores, same calibrated role). Skipped when the
  reranker is active (`pipeline.py:295-299`).
* GroundingValidator — regex-deterministic, no LLM (:98-247): citation
  presence, invented `[Source N]` detection, evasive-phrase detection, and
  the hallucination check that extracts €-amounts / article numbers /
  dates from the answer and requires each to appear in the context.
  `fix_invented_sources` strips citations pointing at nonexistent sources.
"""

from __future__ import annotations

import dataclasses
import re
import unicodedata
from typing import Sequence


@dataclasses.dataclass
class GroundingReport:
    grounded: bool
    issues: list[str]
    has_citations: bool
    invented_sources: list[int]
    severe: bool = False


class RelevanceValidator:
    def __init__(self, min_score: float = 0.0):
        self.min_score = min_score

    def filter_chunks(self, chunks: Sequence) -> list:
        return [c for c in chunks if c.score >= self.min_score]


_CITATION_RE = re.compile(r"\[(?:Sources?)\s+(\d+(?:\s*(?:,|et)\s*\d+)*)\]",
                          re.IGNORECASE)
_AMOUNT_RE = re.compile(
    r"\b(\d{1,3}(?:[  .,]\d{3})*(?:,\d+)?)\s*(?:€|euros?)\b"
    r"|\b(\d+)\s*(?:millions?|M€)\b",
    re.IGNORECASE,
)
_ARTICLE_RE = re.compile(r"\barticles?\s+(\d+(?:-\d+)?(?:\.\d+)?)",
                         re.IGNORECASE)
_DELAY_RE = re.compile(r"\b(\d+)\s*(heures?|jours?|mois|ans?|semaines?)\b",
                       re.IGNORECASE)

_EVASIVE_PHRASES = (
    "je ne peux pas répondre",
    "je n'ai pas accès",
    "en tant qu'intelligence artificielle",
    "je ne dispose pas d'informations",
    "consultez un avocat",
    "les documents fournis ne contiennent aucune information",
)


def _norm(text: str) -> str:
    text = unicodedata.normalize("NFKD", text.lower())
    return "".join(c for c in text if not unicodedata.combining(c))


def extract_citations(text: str) -> list[int]:
    out: list[int] = []
    for m in _CITATION_RE.finditer(text):
        for num in re.findall(r"\d+", m.group(1)):
            out.append(int(num))
    return out


class GroundingValidator:
    """Deterministic (regex) grounding validation; no LLM call."""

    def __init__(self, severe_issue_count: int = 3):
        self.severe_issue_count = severe_issue_count

    def validate(self, answer: str, context: str,
                 n_sources: int) -> GroundingReport:
        issues: list[str] = []
        norm_answer = _norm(answer)
        norm_context = _norm(context)

        citations = extract_citations(answer)
        has_citations = bool(citations)
        if not has_citations and n_sources > 0:
            issues.append("aucune citation [Source N]")

        invented = sorted({c for c in citations if c < 1 or c > n_sources})
        if invented:
            issues.append(f"sources inexistantes citées: {invented}")

        for phrase in _EVASIVE_PHRASES:
            if _norm(phrase) in norm_answer:
                issues.append(f"formulation évasive: «{phrase}»")
                break

        # deterministic hallucination checks: every hard fact in the
        # answer must literally occur in the context
        for m in _AMOUNT_RE.finditer(answer):
            token = (m.group(1) or m.group(2) or "").strip()
            # word-boundary match: a bare substring check lets "4"
            # ride inside "45" (same vacuousness the delay check below
            # guards against — found by the grounding fuzz)
            if token and not re.search(
                    rf"\b{re.escape(_norm(token))}\b", norm_context):
                issues.append(f"montant non sourcé: {token}")
        for m in _ARTICLE_RE.finditer(answer):
            ref = _norm(m.group(1))
            # the context must mention THIS article — "article 5" must
            # not pass because "35" appears somewhere ("art. 83"
            # abbreviations accepted). Enumerations ground too:
            # "articles 12, 13 et 14" must ground "article 13", so the
            # number may sit anywhere inside a digits/comma/et/à span
            # that follows the article keyword (advisor round-2 fix).
            enum_span = r"(?:\d+(?:-\d+)?(?:\.\d+)?\s*(?:,|et|a|à)?\s*)*"
            if not re.search(
                    rf"\bart(?:icles?|\.)?\s+{enum_span}"
                    rf"\b{re.escape(ref)}\b",
                    norm_context):
                issues.append(
                    f"article non sourcé: article {m.group(1)}")
        for m in _DELAY_RE.finditer(answer):
            token = m.group(0)
            # the FULL number+unit token must occur in the context
            # (unit plural/singular tolerated): checking the bare digits
            # would be vacuous — "3" matches inside "article 33"
            number, unit = _norm(m.group(1)), _norm(m.group(2))
            unit_stem = unit.rstrip("s")
            pat = rf"\b{re.escape(number)}\s*{re.escape(unit_stem)}s?\b"
            if not re.search(pat, norm_context):
                issues.append(f"délai non sourcé: {token}")

        severe = len(issues) >= self.severe_issue_count
        return GroundingReport(
            grounded=not issues,
            issues=issues,
            has_citations=has_citations,
            invented_sources=invented,
            severe=severe,
        )

    @staticmethod
    def fix_invented_sources(answer: str, n_sources: int) -> str:
        """Strip `[Source N]` citations with N outside 1..n_sources."""

        def repl(m: re.Match) -> str:
            nums = [int(x) for x in re.findall(r"\d+", m.group(1))]
            keep = [n for n in nums if 1 <= n <= n_sources]
            if not keep:
                return ""
            label = "Source" if len(keep) == 1 else "Sources"
            return f"[{label} {', '.join(map(str, keep))}]"

        fixed = _CITATION_RE.sub(repl, answer)
        return re.sub(r"[ \t]+([.,;])", r"\1", fixed).replace("  ", " ")
