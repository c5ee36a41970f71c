"""Agent tools — all local, zero network (role parity: src/rag/agent/tools.py).

Five tools mirroring the reference inventory (SURVEY.md §2.1):
  1. RGPD deadline table + deadline calculator (deterministic, :27-154)
  2. structured RGPD article index + lookup + related groups + topic search
     (deterministic, :176-308)
  3. question decomposition (LLM, ≤3 sub-questions, :315-377)
  4. answer completeness check (LLM, coverage % + suggested queries,
     :384-438)
Tables independently compiled from the GDPR text (public law).
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import json
import re

from ..providers.base import BaseLLMProvider
from ..rag.intent import extract_json_object

# --------------------------------------------------------------- deadlines

RGPD_DEADLINES: dict[str, dict] = {
    "violation_notification_cnil": {
        "label": "Notification d'une violation de données à la CNIL",
        "duration": {"hours": 72},
        "basis": "article 33 RGPD",
        "notes": "72 heures après en avoir pris connaissance ; au-delà, "
                 "joindre les motifs du retard.",
    },
    "violation_information_personnes": {
        "label": "Information des personnes concernées (risque élevé)",
        "duration": {"days": 0},
        "basis": "article 34 RGPD",
        "notes": "dans les meilleurs délais, sans délai chiffré.",
    },
    "reponse_droits": {
        "label": "Réponse à une demande d'exercice de droits",
        "duration": {"months": 1},
        "basis": "article 12.3 RGPD",
        "notes": "prolongeable de 2 mois pour les demandes complexes, en "
                 "informant la personne dans le premier mois.",
    },
    "reponse_droits_prolongee": {
        "label": "Réponse prolongée (demande complexe)",
        "duration": {"months": 3},
        "basis": "article 12.3 RGPD",
        "notes": "1 mois initial + 2 mois de prolongation.",
    },
    "registre_mise_a_jour": {
        "label": "Mise à jour du registre des traitements",
        "duration": None,
        "basis": "article 30 RGPD",
        "notes": "en continu, à chaque évolution d'un traitement.",
    },
    "aipd_consultation_cnil": {
        "label": "Consultation préalable de la CNIL après AIPD à risque "
                 "résiduel élevé",
        "duration": {"weeks": 8},
        "basis": "article 36 RGPD",
        "notes": "avis de la CNIL sous 8 semaines, prolongeable de 6 "
                 "semaines.",
    },
    "cookies_conservation_consentement": {
        "label": "Durée de validité recommandée du consentement cookies",
        "duration": {"months": 6},
        "basis": "lignes directrices CNIL cookies",
        "notes": "renouvellement du recueil recommandé à 6 mois.",
    },
    "conservation_logs": {
        "label": "Conservation recommandée des journaux de connexion",
        "duration": {"months": 6},
        "basis": "recommandation CNIL journalisation",
        "notes": "6 mois à 1 an selon le contexte de sécurité.",
    },
}


@dataclasses.dataclass
class DeadlineResult:
    event: str
    label: str
    start: str
    deadline: str | None
    basis: str
    notes: str


def calculate_deadline(event_type: str,
                       start_date: str | dt.date | None = None
                       ) -> DeadlineResult | None:
    """Deterministic deadline computation from the table (no LLM)."""
    entry = RGPD_DEADLINES.get(event_type)
    if entry is None:
        return None
    if start_date is None:
        start = dt.date.today()
    elif isinstance(start_date, str):
        start = dt.date.fromisoformat(start_date[:10])
    else:
        start = start_date

    deadline = None
    dur = entry["duration"]
    if dur:
        if "hours" in dur:
            deadline_dt = dt.datetime.combine(
                start, dt.time()
            ) + dt.timedelta(hours=dur["hours"])
            deadline = deadline_dt.isoformat(sep=" ", timespec="minutes")
        elif "weeks" in dur:
            deadline = (start + dt.timedelta(weeks=dur["weeks"])).isoformat()
        elif "months" in dur:
            months = dur["months"]
            month = start.month - 1 + months
            year = start.year + month // 12
            month = month % 12 + 1
            day = min(start.day, [31, 29 if year % 4 == 0 and
                                  (year % 100 != 0 or year % 400 == 0)
                                  else 28, 31, 30, 31, 30, 31, 31, 30, 31,
                                  30, 31][month - 1])
            deadline = dt.date(year, month, day).isoformat()
        elif "days" in dur and dur["days"]:
            deadline = (start + dt.timedelta(days=dur["days"])).isoformat()
    return DeadlineResult(
        event=event_type, label=entry["label"], start=start.isoformat(),
        deadline=deadline, basis=entry["basis"], notes=entry["notes"],
    )


# ---------------------------------------------------------------- articles

RGPD_ARTICLES: dict[str, dict] = {
    "4": {"titre": "Définitions", "themes": ["définitions"],
          "resume": "Définit donnée personnelle, traitement, responsable, "
                    "sous-traitant, consentement, violation…"},
    "5": {"titre": "Principes relatifs au traitement",
          "themes": ["principes", "minimisation", "finalité"],
          "resume": "Licéité, loyauté, transparence, limitation des "
                    "finalités, minimisation, exactitude, conservation "
                    "limitée, intégrité, responsabilité."},
    "6": {"titre": "Licéité du traitement", "themes": ["base légale"],
          "resume": "Les six bases légales: consentement, contrat, "
                    "obligation légale, intérêts vitaux, mission "
                    "d'intérêt public, intérêt légitime."},
    "7": {"titre": "Conditions du consentement",
          "themes": ["consentement"],
          "resume": "Preuve, retrait aussi simple que le recueil, "
                    "liberté du consentement."},
    "8": {"titre": "Consentement des mineurs",
          "themes": ["mineurs", "consentement"],
          "resume": "Seuil de 15 ans en France pour les services en ligne."},
    "9": {"titre": "Catégories particulières de données",
          "themes": ["données sensibles", "santé"],
          "resume": "Interdiction de principe et exceptions (santé, "
                    "biométrie, opinions…)."},
    "10": {"titre": "Données relatives aux condamnations",
           "themes": ["données sensibles"],
           "resume": "Encadrement des données pénales."},
    "12": {"titre": "Transparence et modalités",
           "themes": ["droits des personnes", "délais"],
           "resume": "Information concise et accessible; réponse aux "
                     "demandes sous 1 mois."},
    "13": {"titre": "Information (collecte directe)",
           "themes": ["information", "transparence"],
           "resume": "Mentions obligatoires au moment de la collecte."},
    "14": {"titre": "Information (collecte indirecte)",
           "themes": ["information", "transparence"],
           "resume": "Mentions et délai d'un mois en collecte indirecte."},
    "15": {"titre": "Droit d'accès", "themes": ["droits des personnes"],
           "resume": "Accès aux données et copie."},
    "16": {"titre": "Droit de rectification",
           "themes": ["droits des personnes"],
           "resume": "Correction des données inexactes."},
    "17": {"titre": "Droit à l'effacement",
           "themes": ["droits des personnes", "effacement"],
           "resume": "Effacement («droit à l'oubli») et exceptions."},
    "18": {"titre": "Droit à la limitation",
           "themes": ["droits des personnes"],
           "resume": "Gel temporaire du traitement."},
    "20": {"titre": "Portabilité", "themes": ["droits des personnes"],
           "resume": "Récupération des données dans un format structuré."},
    "21": {"titre": "Droit d'opposition",
           "themes": ["droits des personnes", "prospection"],
           "resume": "Opposition, absolue pour la prospection."},
    "22": {"titre": "Décision individuelle automatisée",
           "themes": ["profilage", "intelligence artificielle"],
           "resume": "Encadrement des décisions entièrement automatisées."},
    "24": {"titre": "Responsabilité du responsable de traitement",
           "themes": ["gouvernance", "accountability"],
           "resume": "Mesures techniques et organisationnelles, "
                     "démonstration de conformité."},
    "25": {"titre": "Protection dès la conception et par défaut",
           "themes": ["privacy by design", "sécurité"],
           "resume": "Privacy by design / by default."},
    "26": {"titre": "Responsables conjoints",
           "themes": ["gouvernance", "contrats"],
           "resume": "Accord transparent répartissant les obligations."},
    "27": {"titre": "Représentant dans l'Union",
           "themes": ["international"],
           "resume": "Désignation d'un représentant UE pour les "
                     "responsables hors UE."},
    "28": {"titre": "Sous-traitant", "themes": ["sous-traitance",
                                                "contrats"],
           "resume": "Contrat obligatoire et ses clauses; garanties "
                     "suffisantes."},
    "29": {"titre": "Traitement sous autorité",
           "themes": ["sous-traitance"],
           "resume": "Le sous-traitant n'agit que sur instruction."},
    "30": {"titre": "Registre des activités de traitement",
           "themes": ["registre", "documentation"],
           "resume": "Contenu du registre RT et sous-traitant; dérogation "
                     "<250 salariés limitée."},
    "32": {"titre": "Sécurité du traitement",
           "themes": ["sécurité"],
           "resume": "Mesures adaptées au risque: chiffrement, "
                     "pseudonymisation, tests, confidentialité."},
    "33": {"titre": "Notification de violation à la CNIL",
           "themes": ["violation", "délais"],
           "resume": "Notification sous 72 h sauf absence de risque; "
                     "documentation interne de toute violation."},
    "34": {"titre": "Communication de violation aux personnes",
           "themes": ["violation"],
           "resume": "Information des personnes en cas de risque élevé."},
    "35": {"titre": "Analyse d'impact (AIPD)",
           "themes": ["aipd", "risques"],
           "resume": "AIPD obligatoire pour les traitements à risque "
                     "élevé; contenu minimal."},
    "36": {"titre": "Consultation préalable",
           "themes": ["aipd", "cnil"],
           "resume": "Consultation de la CNIL si risque résiduel élevé."},
    "37": {"titre": "Désignation du DPO", "themes": ["dpo"],
           "resume": "Cas de désignation obligatoire (autorité publique, "
                     "suivi régulier et systématique à grande échelle, "
                     "données sensibles à grande échelle)."},
    "38": {"titre": "Fonction du DPO", "themes": ["dpo"],
           "resume": "Moyens, indépendance, absence de conflit d'intérêts."},
    "39": {"titre": "Missions du DPO", "themes": ["dpo"],
           "resume": "Information, conseil, contrôle, coopération avec la "
                     "CNIL."},
    "40": {"titre": "Codes de conduite", "themes": ["certification"],
           "resume": "Élaboration de codes de conduite sectoriels."},
    "42": {"titre": "Certification", "themes": ["certification"],
           "resume": "Mécanismes de certification volontaires."},
    "44": {"titre": "Principe des transferts", "themes": ["international"],
           "resume": "Conditions générales des transferts hors UE."},
    "45": {"titre": "Décisions d'adéquation", "themes": ["international"],
           "resume": "Transferts vers pays reconnus adéquats."},
    "46": {"titre": "Garanties appropriées", "themes": ["international"],
           "resume": "CCT, BCR et autres garanties."},
    "47": {"titre": "Règles d'entreprise contraignantes (BCR)",
           "themes": ["international"],
           "resume": "Conditions d'approbation des BCR."},
    "49": {"titre": "Dérogations aux transferts",
           "themes": ["international"],
           "resume": "Dérogations ponctuelles (consentement explicite, "
                     "contrat…)."},
    "58": {"titre": "Pouvoirs des autorités", "themes": ["cnil",
                                                         "sanctions"],
           "resume": "Pouvoirs d'enquête et mesures correctrices."},
    "77": {"titre": "Réclamation auprès d'une autorité",
           "themes": ["recours"],
           "resume": "Droit de plainte auprès de la CNIL."},
    "82": {"titre": "Droit à réparation", "themes": ["recours",
                                                     "responsabilité"],
           "resume": "Réparation du dommage; responsabilité RT / ST."},
    "83": {"titre": "Amendes administratives", "themes": ["sanctions"],
           "resume": "Deux plafonds: 10 M€ / 2 % et 20 M€ / 4 % du CA "
                     "mondial."},
    "89": {"titre": "Archivage, recherche, statistiques",
           "themes": ["recherche", "archivage"],
           "resume": "Garanties pour les traitements à fins d'archivage et "
                     "de recherche."},
}

RELATED_ARTICLE_GROUPS: list[set[str]] = [
    {"6", "7", "8"},            # bases légales / consentement
    {"12", "13", "14"},         # information
    {"15", "16", "17", "18", "20", "21"},  # droits
    {"24", "25", "32"},         # accountability / sécurité
    {"26", "27", "28", "29"},   # acteurs / contrats
    {"33", "34"},               # violations
    {"35", "36"},               # AIPD
    {"37", "38", "39"},         # DPO
    {"44", "45", "46", "47", "49"},  # transferts
    {"58", "77", "82", "83"},   # sanctions / recours
]


def lookup_article(number: str) -> dict | None:
    num = str(number).strip().split(".")[0].split("-")[0]
    entry = RGPD_ARTICLES.get(num)
    if entry is None:
        return None
    related = sorted(
        set().union(*[g for g in RELATED_ARTICLE_GROUPS if num in g])
        - {num}
    ) if any(num in g for g in RELATED_ARTICLE_GROUPS) else []
    return {"numero": num, **entry, "articles_lies": related}


def search_articles_by_topic(topic: str, max_results: int = 5) -> list[dict]:
    low = topic.lower()
    hits = []
    for num, entry in RGPD_ARTICLES.items():
        score = 0
        for theme in entry["themes"]:
            if theme in low or low in theme:
                score += 2
        if low in entry["titre"].lower() or low in entry["resume"].lower():
            score += 1
        if score:
            hits.append((score, num, entry))
    hits.sort(key=lambda x: (-x[0], int(x[1])))
    return [{"numero": n, **e} for _, n, e in hits[:max_results]]


# --------------------------------------------------------------- LLM tools

DECOMPOSE_PROMPT = """La question suivante est-elle composée de plusieurs
questions distinctes ? Si oui, découpe-la en au plus 3 sous-questions
autonomes. Si elle est simple, renvoie une liste vide.

Réponds STRICTEMENT en JSON : {{"sub_questions": ["...", "..."]}}

Question : "{question}"

JSON :"""

DECOMPOSE_GATE_PROMPT = """La question suivante est-elle composée de
plusieurs questions distinctes ?

Question : "{question}"

Réponse (oui ou non) :"""


def _binary_gate(llm: BaseLLMProvider, prompt: str) -> bool | None:
    """Cheap constrained yes/no on choice-capable providers (one
    prefill + one extend, ~75 ms at 12B vs ~1 s for a JSON decode —
    BENCHMARKS.md 'Constrained choice'). None = no capability / error,
    caller falls through to the full JSON call."""
    if not hasattr(llm, "choose"):
        return None
    try:
        best, _ = llm.choose(prompt, ["oui", "non"])
        return best == "oui"
    except Exception:
        return None


def decompose_question(llm: BaseLLMProvider, question: str,
                       max_subs: int = 3) -> list[str]:
    # pre-gate: most questions are simple — a 'non' skips the JSON
    # decompose decode entirely (the common case on the agent path)
    if _binary_gate(llm, DECOMPOSE_GATE_PROMPT.format(
            question=question)) is False:
        return []
    resp = llm.generate(DECOMPOSE_PROMPT.format(question=question),
                        temperature=0.0, json_mode=True)
    if not resp.ok:
        return []
    data = extract_json_object(resp.text)
    if not isinstance(data, dict):
        return []
    subs = data.get("sub_questions") or []
    out = [str(s).strip() for s in subs if str(s).strip()]
    return out[:max_subs] if len(out) >= 2 else []


COMPLETENESS_PROMPT = """Évalue si la réponse couvre tous les aspects de la
question. Réponds STRICTEMENT en JSON :
{{"coverage_pct": <0-100>, "missing_aspects": ["..."],
"suggested_queries": ["..."]}}

Question : "{question}"

Réponse :
{answer}

JSON :"""

COMPLETENESS_GATE_PROMPT = """La réponse suivante couvre-t-elle tous les
aspects de la question ?

Question : "{question}"

Réponse :
{answer}

Couvre tous les aspects (oui ou non) :"""

COVERAGE_CHOOSE_PROMPT = """Quel pourcentage des aspects de la question la
réponse couvre-t-elle ?

Question : "{question}"

Réponse :
{answer}

Pourcentage de couverture (0 à 100) :"""

SUGGEST_QUERY_PROMPT = """La réponse suivante ne couvre pas tous les aspects
de la question. Propose UNE requête de recherche documentaire ciblant les
aspects manquants. Réponds uniquement par la requête, sans guillemets.

Question : "{question}"

Réponse incomplète :
{answer}

Requête :"""


@dataclasses.dataclass
class CompletenessResult:
    coverage_pct: int = 100
    missing_aspects: list[str] = dataclasses.field(default_factory=list)
    suggested_queries: list[str] = dataclasses.field(default_factory=list)


def check_answer_completeness(llm: BaseLLMProvider, question: str,
                              answer: str,
                              query_if_below: int = 80
                              ) -> CompletenessResult:
    """Coverage check at constrained-decision cost (serving economics,
    VERDICT r3 #3). On choice-capable providers the whole check is
    choose()-shaped: a oui/non pre-gate (complete answers — the common
    case — pay ~75 ms at 12B), then an 11-way digit choose for the
    coverage % (like the relevance filter's digit choose) instead of a
    free JSON decode, and a SHORT bounded decode for the re-retrieval
    query only when coverage < `query_if_below` (the only part that
    genuinely needs generation). Providers without choose() fall
    through to the reference-shaped JSON call."""
    gate = _binary_gate(llm, COMPLETENESS_GATE_PROMPT.format(
        question=question, answer=answer[:6000]))
    if gate is True:
        return CompletenessResult()
    if gate is False:
        # constrained coverage: one prefill + one tiny extend
        levels = [str(p) for p in range(0, 101, 10)]
        try:
            best, _ = llm.choose(COVERAGE_CHOOSE_PROMPT.format(
                question=question, answer=answer[:6000]), levels)
            pct = int(best)
        except Exception:
            pct = 100
        queries: list[str] = []
        if pct < query_if_below:
            resp = llm.generate(
                SUGGEST_QUERY_PROMPT.format(question=question,
                                            answer=answer[:6000]),
                temperature=0.0, max_tokens=24,
            )
            if resp.ok:
                q = resp.text.strip().strip('"').splitlines()[0].strip() \
                    if resp.text.strip() else ""
                if len(q) >= 5:
                    queries = [q]
        return CompletenessResult(coverage_pct=max(0, min(100, pct)),
                                  suggested_queries=queries)
    resp = llm.generate(
        COMPLETENESS_PROMPT.format(question=question, answer=answer[:6000]),
        temperature=0.0, json_mode=True,
    )
    if not resp.ok:
        return CompletenessResult()
    data = extract_json_object(resp.text)
    if not isinstance(data, dict):
        return CompletenessResult()
    try:
        pct = int(float(data.get("coverage_pct", 100)))
    except (TypeError, ValueError):
        pct = 100
    return CompletenessResult(
        coverage_pct=max(0, min(100, pct)),
        missing_aspects=[str(x) for x in data.get("missing_aspects") or []],
        suggested_queries=[str(x) for x in
                           data.get("suggested_queries") or []],
    )
