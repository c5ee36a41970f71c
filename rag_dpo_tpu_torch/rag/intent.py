"""LLM intent classification with robust JSON parsing and safe fallback.

Role parity with `src/rag/intent_classifier.py`: classify a question into 7
intents (factuel, methodologique, organisationnel, comparaison, cas_pratique,
liste_exhaustive, refus — :109-112) plus topics / negative topics / flags,
with any parsing or provider error degrading to `factuel` (:192-201).
Prompt independently authored to the same contract.
"""

from __future__ import annotations

import dataclasses
import json
import re

from ..providers.base import BaseLLMProvider
from .topics import RGPD_TOPICS, parse_topic_tags

VALID_INTENTS = (
    "factuel",
    "methodologique",
    "organisationnel",
    "comparaison",
    "cas_pratique",
    "liste_exhaustive",
    "refus",
)

CLASSIFY_PROMPT = """Tu es le module de classification d'un assistant
documentaire RGPD destiné aux délégués à la protection des données.

Analyse la question et produis STRICTEMENT un objet JSON avec ces clés :
- "intent" : une seule valeur parmi {intents}
- "topics" : 1 à 3 thèmes parmi la liste ci-dessous
- "negative_topics" : thèmes explicitement exclus par la question (souvent vide)
- "wants_sources" : true si l'utilisateur attend des références précises
- "is_comparison" : true si la question compare deux notions

Définitions :
- factuel : demande une information précise (définition, délai, seuil).
- methodologique : demande une démarche, des étapes, un "comment faire".
- organisationnel : gouvernance, rôles, responsabilités internes.
- comparaison : met en regard deux notions ou régimes.
- cas_pratique : situation concrète à qualifier juridiquement.
- liste_exhaustive : demande une énumération complète.
- refus : question hors du périmètre protection des données (météo,
  cuisine, actualité générale…) — n'utilise refus QUE dans ce cas.

Pièges : une question RGPD formulée familièrement n'est PAS un refus ;
une demande de délai précis est factuel même si elle décrit un scénario.

Thèmes autorisés : {topics}

Question : "{question}"

JSON :"""


@dataclasses.dataclass
class QuestionIntent:
    intent: str = "factuel"
    topics: list[str] = dataclasses.field(default_factory=list)
    negative_topics: list[str] = dataclasses.field(default_factory=list)
    wants_sources: bool = True
    is_comparison: bool = False
    raw: str = ""

    @property
    def is_refusal(self) -> bool:
        return self.intent == "refus"

    @property
    def is_strict_sourcing(self) -> bool:
        """Intents where invented sources are most damaging."""
        return self.intent in ("factuel", "liste_exhaustive")


def extract_json_object(text: str) -> dict | None:
    """Forgiving JSON extraction: first balanced {...} block, with common
    LLM damage repaired (trailing commas, single quotes, code fences)."""
    text = re.sub(r"```(?:json)?", "", text)
    start = text.find("{")
    if start < 0:
        return None
    depth = 0
    for i in range(start, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                blob = text[start : i + 1]
                for candidate in (blob,
                                  re.sub(r",\s*([}\]])", r"\1", blob),
                                  blob.replace("'", '"')):
                    try:
                        return json.loads(candidate)
                    except json.JSONDecodeError:
                        continue
                return None
    return None


CHOOSE_PROMPT = """Question d'un délégué à la protection des données :
"{question}"

Parmi factuel, methodologique, organisationnel, comparaison,
cas_pratique, liste_exhaustive et refus, l'intention de cette question
est :"""


class IntentClassifier:
    def __init__(self, llm: BaseLLMProvider, fast: bool = False):
        # fast=True: on choice-capable providers, classify by scoring
        # the 7 intents directly (one prefill + one extend, ~84 ms at
        # 12B vs ~1 s for the JSON decode — BENCHMARKS.md "Constrained
        # choice") and detect topics deterministically from the
        # question text. The JSON path remains the fallback and the
        # default (reference-parity flags wants_sources /
        # negative_topics only exist there).
        self.llm = llm
        self.fast = fast

    def _choose_intent(self, question: str) -> str | None:
        """Constrained fallback on providers that support it (the TPU
        decoder's `choose`): rank the 7 intents by teacher-forced
        log-likelihood — the answer is always a valid intent, so a
        malformed JSON no longer silently degrades to 'factuel'."""
        if not hasattr(self.llm, "choose"):
            return None
        try:
            best, _ = self.llm.choose(
                CHOOSE_PROMPT.format(question=question), VALID_INTENTS)
            return best
        except Exception:
            return None

    def classify(self, question: str) -> QuestionIntent:
        if self.fast:
            chosen = self._choose_intent(question)
            if chosen:
                from .topics import detect_topics

                return QuestionIntent(
                    intent=chosen,
                    topics=detect_topics(question),
                    wants_sources=True,
                    is_comparison=(chosen == "comparaison"),
                )
            # no capability / scoring error: fall through to JSON
        prompt = CLASSIFY_PROMPT.format(
            intents=", ".join(VALID_INTENTS),
            topics="; ".join(RGPD_TOPICS),
            question=question,
        )
        resp = self.llm.generate(prompt, temperature=0.0, json_mode=True)
        fallback = QuestionIntent(raw=resp.text if resp.ok else "")
        if not resp.ok:
            return fallback
        data = extract_json_object(resp.text)
        if not isinstance(data, dict):
            chosen = self._choose_intent(question)
            if chosen:
                return dataclasses.replace(fallback, intent=chosen)
            return fallback
        intent = str(data.get("intent", "factuel")).strip().lower()
        if intent not in VALID_INTENTS:
            intent = self._choose_intent(question) or "factuel"
        topics = data.get("topics") or []
        if isinstance(topics, str):
            topics = parse_topic_tags(topics)
        else:
            topics = parse_topic_tags(", ".join(str(t) for t in topics))
        neg = data.get("negative_topics") or []
        if isinstance(neg, str):
            neg = parse_topic_tags(neg)
        else:
            neg = parse_topic_tags(", ".join(str(t) for t in neg))
        return QuestionIntent(
            intent=intent,
            topics=topics,
            negative_topics=neg,
            wants_sources=bool(data.get("wants_sources", True)),
            is_comparison=bool(data.get("is_comparison",
                                        intent == "comparaison")),
            raw=resp.text,
        )
