"""Document & chunk classification (rules-first, LLM only when ambiguous).

Role parity with `src/processing/classify_documents.py` (LLM JSON
nature/secteurs/importance + `ClassificationValidator` auto-correction)
and the chunk-level `ChunkClassifier` of `process_and_chunk.py:1107-1318`
(hard rules → score-gap ambiguity test → constrained 2-option LLM call on
<10% of chunks). The rules-first design keeps LLM traffic minimal — the
reference's measured target is <10% ambiguous (:1675).
"""

from __future__ import annotations

import dataclasses

from ..providers.base import BaseLLMProvider
from ..rag.intent import extract_json_object

NATURES = ("DOCTRINE", "GUIDE", "SANCTION", "TECHNIQUE", "MIXTE")

DOC_CLASSIFY_PROMPT = """Classifie ce document CNIL/RGPD. Réponds
STRICTEMENT en JSON :
{{"nature": "DOCTRINE|GUIDE|SANCTION|TECHNIQUE|MIXTE",
"secteurs": ["..."], "importance": <1-10>,
"type_document": "...", "mots_cles": ["..."]}}

- DOCTRINE : position juridique, interprétation des textes.
- GUIDE : mode d'emploi, recommandations pratiques.
- SANCTION : délibération, mise en demeure, amende.
- TECHNIQUE : mesures de sécurité, configuration.
- MIXTE : plusieurs natures à parts égales.

Titre : {title}
Extrait :
{excerpt}

JSON :"""

NATURE_CHOOSE_PROMPT = """Parmi DOCTRINE (position juridique), GUIDE
(recommandations pratiques), SANCTION (délibération, amende), TECHNIQUE
(mesures de sécurité) et MIXTE, la nature de ce document CNIL/RGPD est :

Titre : {title}
Extrait :
{excerpt}

Nature :"""


@dataclasses.dataclass
class DocClassification:
    nature: str = "MIXTE"
    secteurs: list[str] = dataclasses.field(default_factory=list)
    importance: int = 5
    type_document: str = ""
    mots_cles: list[str] = dataclasses.field(default_factory=list)


class ClassificationValidator:
    """Rule-based auto-correction of LLM output (role parity:
    `src/processing/classification_validator.py`)."""

    def correct(self, c: DocClassification, title: str,
                text: str) -> DocClassification:
        low = (title + " " + text[:2000]).lower()
        if c.nature not in NATURES:
            c.nature = "MIXTE"
        # sanctions are unambiguous: deliberation numbers / fines
        if ("délibération san" in low or "mise en demeure" in low
                or "sanction de" in low) and c.nature != "SANCTION":
            c.nature = "SANCTION"
        if c.nature == "SANCTION" and "amende" not in low \
                and "sanction" not in low and "mise en demeure" not in low:
            c.nature = "MIXTE"
        c.importance = max(1, min(10, int(c.importance or 5)))
        c.secteurs = [str(s).lower() for s in (c.secteurs or [])][:5]
        return c


class DocumentClassifier:
    def __init__(self, llm: BaseLLMProvider, cache: dict | None = None):
        self.llm = llm
        self.validator = ClassificationValidator()
        self.cache = cache if cache is not None else {}

    def classify(self, doc_id: str, title: str,
                 text: str) -> DocClassification:
        import hashlib

        content_hash = hashlib.sha256(
            (title + "\x00" + text[:4000]).encode()).hexdigest()[:16]
        cached = self.cache.get(doc_id)
        if cached is not None:  # resume support (reference :99-112)
            # a re-classified CHANGED document must not return the stale
            # entry (incremental-update flow — review finding); legacy
            # cache entries without a hash stay valid
            if cached.get("content_hash", content_hash) == content_hash:
                data = {k: v for k, v in cached.items()
                        if k != "content_hash"}
                return DocClassification(**data)
        resp = self.llm.generate(
            DOC_CLASSIFY_PROMPT.format(title=title, excerpt=text[:4000]),
            temperature=0.0, json_mode=True,
        )
        c = DocClassification()
        if resp.ok:
            data = extract_json_object(resp.text)
            if isinstance(data, dict):
                c = DocClassification(
                    nature=str(data.get("nature", "MIXTE")).upper(),
                    secteurs=list(data.get("secteurs") or []),
                    importance=_safe_int(data.get("importance"), 5),
                    type_document=str(data.get("type_document", "")),
                    mots_cles=[str(m) for m in
                               (data.get("mots_cles") or [])][:10],
                )
        if c.nature not in NATURES and hasattr(self.llm, "choose"):
            # malformed JSON or invalid nature: score the 5 natures
            # teacher-forced instead of silently degrading to MIXTE
            try:
                c.nature, _ = self.llm.choose(
                    NATURE_CHOOSE_PROMPT.format(
                        title=title, excerpt=text[:4000]),
                    list(NATURES))
            except Exception:
                pass
        c = self.validator.correct(c, title, text)
        self.cache[doc_id] = {**dataclasses.asdict(c),
                              "content_hash": content_hash}
        return c


def _safe_int(v, default):
    try:
        return int(float(v))
    except (TypeError, ValueError):
        return default


CHUNK_CLASSIFY_PROMPT = """Ce passage relève-t-il plutôt de
«{option_a}» ou de «{option_b}» ? Réponds par un seul mot : {option_a}
ou {option_b}.

Passage :
{excerpt}

Réponse :"""


class ChunkClassifier:
    """Hard rules → score-gap ambiguity test → constrained 2-option LLM."""

    def __init__(self, llm: BaseLLMProvider | None = None,
                 ambiguity_gap: float = 1.0):
        self.llm = llm
        self.ambiguity_gap = ambiguity_gap
        self.n_llm_calls = 0
        self.n_total = 0

    def _rule_scores(self, features: dict, text: str) -> dict[str, float]:
        scores = {n: 0.0 for n in NATURES if n != "MIXTE"}
        if features.get("has_sanctions"):
            scores["SANCTION"] += 2.0
        if features.get("has_amounts"):
            scores["SANCTION"] += 1.0
        if features.get("has_steps"):
            scores["GUIDE"] += 2.0
        if features.get("has_template"):
            scores["GUIDE"] += 1.0
        if features.get("has_technical"):
            scores["TECHNIQUE"] += 2.0
        if features.get("has_article_refs"):
            scores["DOCTRINE"] += 1.5
        if features.get("has_obligations"):
            scores["DOCTRINE"] += 0.5
        return scores

    def classify(self, text: str, features: dict) -> str:
        self.n_total += 1
        scores = self._rule_scores(features, text)
        ranked = sorted(scores.items(), key=lambda kv: -kv[1])
        best, second = ranked[0], ranked[1]
        if best[1] == 0.0:
            return "MIXTE"
        if best[1] - second[1] >= self.ambiguity_gap or self.llm is None:
            return best[0]
        # truly ambiguous → constrained two-option LLM call
        self.n_llm_calls += 1
        prompt = CHUNK_CLASSIFY_PROMPT.format(
            option_a=best[0], option_b=second[0], excerpt=text[:1500]
        )
        if hasattr(self.llm, "choose"):
            # TPU decoder: score both options teacher-forced — the
            # answer is structurally one of the two, no regex rescue
            try:
                chosen, _ = self.llm.choose(prompt,
                                            [best[0], second[0]])
                return chosen
            except Exception:
                return best[0]
        resp = self.llm.generate(prompt, temperature=0.0)
        if resp.ok:
            answer = resp.text.strip().upper()
            for option in (best[0], second[0]):
                if option in answer:
                    return option
        return best[0]
