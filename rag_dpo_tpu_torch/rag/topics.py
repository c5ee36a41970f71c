"""Controlled RGPD topic vocabulary + semantic topic matching.

Role parity with `src/utils/rgpd_topics.py`: a 25-category controlled
vocabulary used to tag chunks (`tag_all_chunks.py`), a tag normalizer for
LLM output, and a TopicMatcher that turns question-topic ↔ chunk-tag
cosine similarity into an additive rerank bonus of at most +0.15 above a
0.65 similarity threshold (`rgpd_topics.py:178-222`, applied by the
reranker at `reranker.py:169-193`). Vocabulary independently compiled.
"""

from __future__ import annotations

import numpy as np

RGPD_TOPICS: list[str] = [
    "base légale et consentement",
    "droits des personnes",
    "information et transparence",
    "registre des traitements",
    "analyse d'impact (AIPD)",
    "sécurité des données",
    "violation de données",
    "sous-traitance",
    "transferts internationaux",
    "durée de conservation",
    "minimisation des données",
    "données sensibles",
    "données de santé",
    "données des mineurs",
    "vidéosurveillance",
    "cookies et traceurs",
    "prospection commerciale",
    "ressources humaines et salariés",
    "délégué à la protection des données",
    "sanctions et contrôles CNIL",
    "responsabilité et gouvernance",
    "certification et labels",
    "recherche et statistiques",
    "intelligence artificielle",
    "secteur public et collectivités",
]


# trigger terms per topic for DETERMINISTIC detection from question
# text (fast intent path: no LLM call). Normalized accent-free
# substring match; triggers chosen to be unambiguous in DPO questions.
_TOPIC_TRIGGERS: dict[str, tuple[str, ...]] = {
    "base légale et consentement": ("base legale", "consentement",
                                    "interet legitime", "licéite",
                                    "liceite"),
    "droits des personnes": ("droit d'acces", "droits des personnes",
                             "effacement", "portabilite",
                             "rectification", "droit d'opposition",
                             "demande d'acces"),
    "information et transparence": ("transparence", "mention d'information",
                                    "politique de confidentialite",
                                    "information des personnes"),
    "registre des traitements": ("registre",),
    "analyse d'impact (AIPD)": ("aipd", "analyse d'impact", "pia",
                                "etude d'impact"),
    "sécurité des données": ("securite", "chiffrement", "pseudonymisation",
                             "mot de passe", "habilitation"),
    "violation de données": ("violation", "fuite de donnees",
                             "notification a la cnil"),
    "sous-traitance": ("sous-traitant", "sous-traitance", "article 28",
                       "prestataire"),
    "transferts internationaux": ("transfert", "hors ue", "etats-unis",
                                  "clauses contractuelles types",
                                  "adequation"),
    "durée de conservation": ("conservation", "duree de conservation",
                              "archivage", "purge"),
    "minimisation des données": ("minimisation",),
    "données sensibles": ("donnees sensibles", "categories particulieres",
                          "biometrique", "opinions"),
    "données de santé": ("sante", "medical", "hds", "patient"),
    "données des mineurs": ("mineur", "enfant", "eleve", "scolaire"),
    "vidéosurveillance": ("videosurveillance", "camera", "videoprotection"),
    "cookies et traceurs": ("cookie", "traceur", "mesure d'audience"),
    "prospection commerciale": ("prospection", "marketing", "demarchage",
                                "newsletter"),
    "ressources humaines et salariés": ("salarie", "employe", "rh",
                                        "recrutement", "paie",
                                        "badgeage"),
    "délégué à la protection des données": ("dpo", "delegue a la protection",
                                            "designation du delegue"),
    "sanctions et contrôles CNIL": ("sanction", "amende", "controle",
                                    "mise en demeure", "deliberation"),
    "responsabilité et gouvernance": ("responsable de traitement",
                                      "accountability", "gouvernance",
                                      "responsabilite conjointe"),
    "certification et labels": ("certification", "label", "code de conduite"),
    "recherche et statistiques": ("recherche", "statistique", "archives"),
    "intelligence artificielle": ("intelligence artificielle", " ia ",
                                  "algorithme", "apprentissage"),
    "secteur public et collectivités": ("collectivite", "commune", "mairie",
                                        "secteur public",
                                        "administration"),
}


def _fold(text: str) -> str:
    import unicodedata

    folded = unicodedata.normalize("NFKD", text.lower())
    return "".join(c for c in folded if not unicodedata.combining(c))


def detect_topics(text: str, max_tags: int = 3) -> list[str]:
    """Deterministic topic detection from question text (accent-folded
    trigger substrings). Used by the fast intent path in place of the
    LLM's JSON topic list; empty result is safe (the topic boost simply
    doesn't apply)."""
    low = f" {_fold(text)} "
    out = []
    for topic in RGPD_TOPICS:
        for trig in _TOPIC_TRIGGERS.get(topic, ()):
            if trig in low:
                out.append(topic)
                break
        if len(out) >= max_tags:
            break
    return out


def parse_topic_tags(raw: str, max_tags: int = 3) -> list[str]:
    """Normalize LLM tag output onto the controlled vocabulary
    (split on , ; / newline, fuzzy containment match, cap at 3)."""
    if not raw:
        return []
    import re

    out: list[str] = []
    for piece in re.split(r"[,;/\n]+", raw):
        cand = piece.strip().strip("-•* ").lower()
        if not cand:
            continue
        for topic in RGPD_TOPICS:
            t = topic.lower()
            if cand == t or cand in t or t in cand:
                if topic not in out:
                    out.append(topic)
                break
        if len(out) >= max_tags:
            break
    return out


class TopicMatcher:
    """Embedding-cached topic similarity → additive rerank boost."""

    def __init__(self, embedder, threshold: float = 0.65,
                 max_boost: float = 0.15):
        self.embedder = embedder
        self.threshold = threshold
        self.max_boost = max_boost
        self._cache: dict[str, np.ndarray] = {}

    def _vec(self, text: str) -> np.ndarray:
        v = self._cache.get(text)
        if v is None:
            v = self.embedder.embed_queries([text])[0]
            self._cache[text] = v
        return v

    def topic_boost(self, question_topics: list[str],
                    chunk_tags: list[str]) -> float:
        """Max pairwise cosine above threshold, scaled into [0, max_boost]."""
        if not question_topics or not chunk_tags:
            return 0.0
        best = 0.0
        for qt in question_topics:
            qv = self._vec(qt)
            for ct in chunk_tags:
                cv = self._vec(ct)
                best = max(best, float(np.dot(qv, cv)))
        if best <= self.threshold:
            return 0.0
        frac = (best - self.threshold) / (1.0 - self.threshold)
        return self.max_boost * min(1.0, frac)
