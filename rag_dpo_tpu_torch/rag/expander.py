"""LLM query expansion: 3 reformulations + graceful fallback.

Role parity with the reference's QueryExpander (`src/rag/query_expander.py`:
prompt at :19-27, expand at :66-113 — temp 0.7, numbered-list parse with
quality filters, fallback to [original] on any error). The multi-query
output feeds the batched dense/sparse arms of the retriever.
"""

from __future__ import annotations

import re

from ..providers.base import BaseLLMProvider

EXPANSION_PROMPT = """Tu aides un moteur de recherche documentaire RGPD/CNIL.
Reformule la question suivante de {n} façons différentes pour maximiser la
couverture de recherche. Chaque reformulation doit rester fidèle au sens,
utiliser un vocabulaire juridique ou opérationnel varié, et tenir en une
phrase. Réponds UNIQUEMENT par une liste numérotée.

Question : "{question}"
"""

# parallel mode: one reformulation per request, each with a distinct
# angle — the diversity the single-call prompt asks sampling for is
# made structural instead
SINGLE_PROMPT = """Tu aides un moteur de recherche documentaire RGPD/CNIL.
{angle}, en restant fidèle au sens et en une seule phrase.
Réponds UNIQUEMENT par la reformulation, sans préambule.

Question : "{question}"
"""

ANGLES = (
    "Reformule la question avec un vocabulaire juridique différent",
    "Reformule la question de façon plus générale",
    "Reformule la question de façon plus spécifique et opérationnelle",
    "Reformule la question comme la poserait un non-juriste",
)


class QueryExpander:
    def __init__(self, llm: BaseLLMProvider, n_expansions: int = 3,
                 temperature: float = 0.7,
                 parallel: bool | None = None):
        """`parallel=None` auto-enables the fan-out on providers with a
        continuous decode pool: n single-reformulation requests decode
        CO-RESIDENT in the same weight sweeps, so the expansion wall
        drops from one ~96-token decode (~1.9 s at 12B) to the longest
        single reformulation (~35 tokens) — the solo-TTFT long pole
        (BENCHMARKS.md: expansion dominates the intent∥expansion
        overlap window)."""
        self.llm = llm
        self.n_expansions = n_expansions
        self.temperature = temperature
        self.parallel = parallel

    def _use_parallel(self) -> bool:
        if self.parallel is not None:
            return self.parallel
        return getattr(self.llm, "_driver", None) is not None

    def expand(self, question: str) -> list[str]:
        """→ [original, reformulation…] (always starts with the original)."""
        if self.n_expansions <= 0:
            return [question]
        if self.n_expansions > 1 and self._use_parallel():
            refs = self._expand_parallel(question)
            if refs:
                return [question] + refs[: self.n_expansions]
            return [question]
        resp = self.llm.generate(
            EXPANSION_PROMPT.format(question=question, n=self.n_expansions),
            temperature=self.temperature,
        )
        if not resp.ok or not resp.text.strip():
            return [question]
        refs = self._parse(resp.text, question)
        return [question] + refs[: self.n_expansions]

    def _expand_parallel(self, question: str) -> list[str]:
        from concurrent.futures import ThreadPoolExecutor

        def one(i: int) -> str:
            resp = self.llm.generate(
                SINGLE_PROMPT.format(angle=ANGLES[i % len(ANGLES)],
                                     question=question),
                # 3 x 36 tokens ~= the old single 96-token list:
                # parallel mode must not cost the pool more decode
                # than it replaced (a truncated reformulation is
                # still a fine SEARCH query - it feeds the encoder)
                temperature=self.temperature, max_tokens=36,
            )
            if not resp.ok:
                return ""
            for line in resp.text.splitlines():
                line = re.sub(r"^\s*(?:\d+[.)]\s*|[-*]\s+)", "",
                              line).strip().strip('"').strip()
                if line:
                    return line
            return ""

        n = self.n_expansions
        with ThreadPoolExecutor(max_workers=n) as ex:
            raw = list(ex.map(one, range(n)))
        out: list[str] = []
        for cand in raw:
            if not (10 <= len(cand) <= 300):
                continue
            if cand.lower() == question.lower() or cand in out:
                continue
            out.append(cand)
        return out

    def _parse(self, text: str, original: str) -> list[str]:
        out: list[str] = []
        for line in text.splitlines():
            m = re.match(r"\s*(?:\d+[.)]\s*|[-*]\s+)(.+)", line)
            if not m:
                continue
            cand = m.group(1).strip().strip('"').strip()
            # quality filters: length sane, not a copy of the original
            if not (10 <= len(cand) <= 300):
                continue
            if cand.lower() == original.lower():
                continue
            if cand in out:
                continue
            out.append(cand)
        return out
