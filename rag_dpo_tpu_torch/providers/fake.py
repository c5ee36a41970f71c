"""Deterministic fake LLM provider for tests and offline runs.

The reference has no fake backend at all (SURVEY.md §4: "no fake LLM, no
in-memory vector-store stub"); every quality mechanism depends on a live
Ollama. This fake makes the whole pipeline testable hermetically: it
pattern-matches the *task* being asked (intent classification, query
expansion, decomposition, completeness, generation…) from the prompt
structure and returns well-formed deterministic outputs.
"""

from __future__ import annotations

import hashlib
import json
import re
from typing import Callable, Sequence

from .base import BaseLLMProvider, LLMResponse

Rule = tuple[Callable[[str, str], bool], Callable[[str, str], str]]


def _h(text: str) -> int:
    return int(hashlib.md5(text.encode()).hexdigest(), 16)


class FakeLLMProvider(BaseLLMProvider):
    model_name = "fake-deterministic"

    def __init__(self, rules: Sequence[Rule] | None = None,
                 default: Callable[[str, str], str] | None = None):
        self.rules = list(rules or [])
        self.default = default
        self.calls: list[dict] = []  # recorded for assertions

    def generate(self, prompt, system=None, temperature=0.0,
                 json_mode=False, max_tokens=None) -> LLMResponse:
        system = system or ""
        self.calls.append({"prompt": prompt, "system": system,
                           "temperature": temperature,
                           "json_mode": json_mode})
        for match, respond in self.rules:
            if match(prompt, system):
                return LLMResponse(respond(prompt, system), self.model_name)
        if self.default is not None:
            return LLMResponse(self.default(prompt, system), self.model_name)
        return LLMResponse(self._auto(prompt, system, json_mode),
                           self.model_name)

    # ---------------------------------------------------------- auto mode
    def _auto(self, prompt: str, system: str, json_mode: bool) -> str:
        text = prompt + "\n" + system
        low = text.lower()
        if "intention" in low and "json" in low:
            return json.dumps({
                "intent": "factuel",
                "topics": ["obligations et conformité"],
                "negative_topics": [],
                "wants_sources": True,
                "is_comparison": False,
            })
        if "reformule la question suivante" in low:
            # query-expansion prompt signature (rag/expander.py) — keyed
            # on the full phrase: the intent system prompts legitimately
            # contain words like « reformulation »
            q = _last_question(prompt)
            return (f"1. {q} selon le RGPD\n"
                    f"2. {q} obligations CNIL\n"
                    f"3. {q} cadre légal")
        if "sous-questions" in low or "décompose" in low:
            return json.dumps({"sub_questions": []})
        if "couverture" in low or "complétude" in low:
            return json.dumps({"coverage_pct": 95,
                               "missing_aspects": [],
                               "suggested_queries": []})
        if "réécri" in low or "reformule la question" in low:
            return _last_question(prompt)
        if "[source" in low or "contexte" in low:
            # generation: cite the first two sources, echo key facts
            return (
                "D'après la documentation CNIL, les obligations applicables "
                "sont décrites dans les sources fournies [Source 1]. "
                "Le responsable de traitement doit documenter sa conformité "
                "[Source 2]."
            )
        # fallback: deterministic echo
        return f"Réponse déterministe ({_h(text) % 1000})."


def _last_question(prompt: str) -> str:
    m = re.findall(r"[\"«]([^\"»]{10,200})[\"»]", prompt)
    if m:
        return m[-1].strip()
    lines = [l.strip() for l in prompt.splitlines() if l.strip()]
    return lines[-1][:120] if lines else "question"
