"""Corpus relevance filter (keep/exclude per scraped document).

Role parity with `src/processing/hybrid_filter.py`: obvious-URL excludes
(:38-48), weighted keyword prescoring (:59-90), then a DPO-persona LLM
scoring prompt keeping documents scored ≥ 6 (:93-120). The prescore
short-circuits the LLM for clear keeps/excludes.
"""

from __future__ import annotations

import dataclasses
import re

from ..providers.base import BaseLLMProvider
from ..rag.intent import extract_json_object

_URL_EXCLUDES = (
    r"/presse/", r"/actualite", r"/agenda", r"/recrutement", r"/contact",
    r"/mentions-legales", r"/newsletter", r"/rss", r"\.xml$", r"/en/",
    r"/plan-du-site",
)

_KEYWORD_WEIGHTS = {
    "rgpd": 3, "donnees personnelles": 3, "traitement": 2, "cnil": 1,
    "dpo": 3, "delegue a la protection": 3, "aipd": 3, "registre": 2,
    "sous-traitant": 3, "violation": 2, "consentement": 2, "sanction": 2,
    "droits des personnes": 3, "securite": 1, "conservation": 2,
    "transfert": 2, "cookie": 2, "videosurveillance": 2,
}

FILTER_PROMPT = """Tu es délégué à la protection des données. Évalue
l'utilité de ce document pour ta pratique quotidienne (conformité RGPD,
doctrine CNIL, modèles, sanctions) sur une échelle de 0 à 10.
Réponds STRICTEMENT en JSON : {{"score": <0-10>, "raison": "<courte>"}}

URL : {url}
Titre : {title}
Extrait :
{excerpt}

JSON :"""

CHOOSE_FILTER_PROMPT = """Tu es délégué à la protection des données.
Évalue l'utilité de ce document pour ta pratique quotidienne
(conformité RGPD, doctrine CNIL, modèles, sanctions) sur une échelle
de 0 à 10.

URL : {url}
Titre : {title}
Extrait :
{excerpt}

Score (0-10) :"""


@dataclasses.dataclass
class FilterDecision:
    keep: bool
    score: float
    method: str            # url_exclude | prescore | llm
    reason: str = ""


class RelevanceFilter:
    def __init__(self, llm: BaseLLMProvider | None = None,
                 keep_threshold: float = 6.0,
                 prescore_keep: int = 8, prescore_drop: int = 1):
        self.llm = llm
        self.keep_threshold = keep_threshold
        self.prescore_keep = prescore_keep
        self.prescore_drop = prescore_drop

    def prescore(self, title: str, text: str) -> int:
        import unicodedata

        low = unicodedata.normalize("NFKD", (title + " " + text).lower())
        low = "".join(c for c in low if not unicodedata.combining(c))
        return sum(w for kw, w in _KEYWORD_WEIGHTS.items() if kw in low)

    def decide(self, url: str, title: str, text: str) -> FilterDecision:
        for pat in _URL_EXCLUDES:
            if re.search(pat, url):
                return FilterDecision(False, 0.0, "url_exclude", pat)
        score = self.prescore(title, text)
        if score >= self.prescore_keep:
            return FilterDecision(True, float(score), "prescore")
        if score <= self.prescore_drop or self.llm is None:
            return FilterDecision(score > self.prescore_drop,
                                  float(score), "prescore")
        if hasattr(self.llm, "choose"):
            # TPU decoder: EXPECTED score over the 11 digit candidates
            # (softmax of teacher-forced log-probs) — calibrated, no
            # JSON rescue, one prefill + one tiny extend
            try:
                import math

                # normalize=False: the softmax needs the JOINT log-prob
                # of each candidate ('10' is two tokens — its chain
                # probability already prices that; a per-token mean
                # would overweight it)
                _, lp = self.llm.choose(
                    CHOOSE_FILTER_PROMPT.format(
                        url=url, title=title, excerpt=text[:3000]),
                    [str(i) for i in range(11)], normalize=False)
                m = max(lp)
                w = [math.exp(x - m) for x in lp]
                exp_score = sum(i * wi for i, wi in enumerate(w)) \
                    / sum(w)
                return FilterDecision(
                    exp_score >= self.keep_threshold,
                    round(exp_score, 2), "choose")
            except Exception:
                pass
        resp = self.llm.generate(
            FILTER_PROMPT.format(url=url, title=title,
                                 excerpt=text[:3000]),
            temperature=0.0, json_mode=True,
        )
        if resp.ok:
            data = extract_json_object(resp.text)
            if isinstance(data, dict) and "score" in data:
                try:
                    llm_score = float(data["score"])
                except (TypeError, ValueError):
                    llm_score = 0.0
                return FilterDecision(
                    llm_score >= self.keep_threshold, llm_score, "llm",
                    str(data.get("raison", "")),
                )
        # degraded: fall back to prescore midpoint
        return FilterDecision(score >= 4, float(score), "prescore")
