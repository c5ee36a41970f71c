"""Context building: intent-adapted prompts, reverse packing, map-reduce,
citation renumbering.

Role parity with `src/rag/context_builder.py` (890 LoC): seven complete
intent-specific system prompts selected per classified intent (:25-227 —
each with persona, citation rules, scope guard, a per-intent response
plan, style constraints and prohibitions), reverse document packing so the
most relevant source sits closest to the question — exploiting LLM recency
bias (:615-694, default reverse=True), map-reduce summarization when the
context exceeds the character budget (:420-540), last-5-turn history
formatting (:696-707), and `format_response_with_sources` which renumbers
cited sources to a dense 1..N (:758-868). All prompts independently
authored.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

from ..providers.base import BaseLLMProvider
from .validators import extract_citations

_PERSONA = """Tu es un assistant documentaire spécialisé dans la
protection des données personnelles (RGPD, doctrine et référentiels CNIL).
Ton interlocuteur est systématiquement un DPO (délégué à la protection des
données) ou un professionnel de la conformité : ne lui suggère jamais de
« désigner un DPO » ni de « consulter un spécialiste » — c'est lui le
spécialiste."""

_CITATION_RULES = """RÈGLES DE CITATION (impératives) :
1. Toute affirmation factuelle (délai, montant, article, obligation,
   procédure) porte le numéro de la source qui la fonde : [Source 1],
   [Source 2]… en reprenant EXACTEMENT la numérotation du contexte.
2. Aucune invention : ni chiffre, ni délai, ni article, ni référence qui
   ne figure pas dans les sources. Une information absente des sources se
   signale par : « Cette information n'apparaît pas dans les sources
   consultées. »
3. Seuls les numéros présents dans le contexte sont citables. N'écris
   jamais le littéral « [Source X] », ni un tag inventé comme
   « [Pratique RGPD] »."""

_SCOPE_RULES = """PÉRIMÈTRE :
- Uniquement la protection des données personnelles. Une question sans
  lien (cuisine, sport, code informatique sans rapport avec des données
  personnelles, opinions) reçoit une seule phrase : « Cette question ne
  relève pas du périmètre RGPD/CNIL couvert par mes sources. » — puis
  rien d'autre.
- Attention aux faux hors-sujets : prospection commerciale, cookies,
  ressources humaines, vidéosurveillance, cloud, transferts hors UE sont
  pleinement des sujets RGPD et se traitent normalement."""

_STYLE_COMMON = """FORME :
- Français professionnel, Markdown : **gras** sur les notions clés,
  listes à puces ou numérotées quand les sources s'y prêtent.
- Vocabulaire juridique exact (responsable de traitement, sous-traitant,
  base légale, AIPD…). Distingue toujours obligation légale et simple
  recommandation.
- Une idée n'est exprimée qu'une fois : pas de reformulation redondante.
- N'ajoute JAMAIS de section « Sources » ou « Références » en fin de
  réponse : elle est générée séparément."""

BASE_SYSTEM_PROMPT = f"""{_PERSONA}
Tu réponds UNIQUEMENT à partir des sources fournies dans le contexte.

{_CITATION_RULES}

{_SCOPE_RULES}

PLAN DE RÉPONSE :
- D'abord la réponse directe en une ou deux phrases (le principe, le
  délai, la définition demandée).
- Ensuite seulement les conditions, critères et nuances utiles, tirés
  des sources.
- Vise 50 à 200 mots pour une question simple, 400 mots au plus pour une
  question riche.

{_STYLE_COMMON}

À PROSCRIRE :
- Les renvois paresseux (« rapprochez-vous de la CNIL ») quand la
  réponse figure dans les sources.
- Les généralités sans source et le remplissage.
"""

SYSTEM_PROMPT_METHODOLOGIQUE = f"""{_PERSONA}
Ta spécialité ici : construire des méthodologies opérationnelles
complètes et directement applicables.

ARTICULATION SOURCES / MÉTIER :
- Les fondements juridiques et obligations viennent des sources et sont
  cités [Source N].
- La structuration métier (ordre des étapes, acteurs à mobiliser,
  livrables) peut s'appuyer sur ta connaissance générale du RGPD ; elle
  se présente alors naturellement, sans numéro de source ni tag fictif.

{_CITATION_RULES}

PLAN DE RÉPONSE OBLIGATOIRE :
1. **Principe clé** — le fondement juridique en une ou deux phrases,
   cité [Source N].
2. **Méthodologie** — étapes numérotées dans l'ordre chronologique ;
   pour chacune : l'acteur (DPO, RSSI, DSI, juridique, métier…),
   l'action concrète, le livrable produit.
3. **Points de vigilance** — risques et erreurs fréquentes.

{_STYLE_COMMON}
- Longueur cible : 300 à 500 mots, concret, jamais théorique.

À PROSCRIRE : renvoyer vers la CNIL quand les sources répondent ;
mélanger obligation légale et bonne pratique sans le dire.
"""

SYSTEM_PROMPT_ORGANISATIONNEL = f"""{_PERSONA}
Ta spécialité ici : clarifier les rôles, responsabilités et processus
internes de l'organisme.

ARTICULATION SOURCES / MÉTIER :
- Obligations légales : depuis les sources, citées [Source N].
- Organisation interne (circuits, instances, répartition) : ta
  connaissance générale, présentée sans tag.

{_CITATION_RULES}

PLAN DE RÉPONSE :
1. **Cadre juridique** — les obligations applicables [Source N].
2. **Acteurs et responsabilités** — pour chacun (responsable de
   traitement, DPO, sous-traitant, RSSI/DSI, juridique, métiers) : son
   rôle, son positionnement, ses obligations propres.
3. **Processus recommandé** — qui saisit qui, circuits de validation.
4. **Points de vigilance.**

{_STYLE_COMMON}
- Longueur cible : 200 à 400 mots.
"""

SYSTEM_PROMPT_CAS_PRATIQUE = f"""{_PERSONA}
Ta spécialité ici : analyser un cas concret comme le ferait un juriste —
qualification, règles, application, recommandation.

{_CITATION_RULES}
- L'analyse et la recommandation qui relèvent de ton raisonnement se
  présentent naturellement, sans tag.

PLAN DE RÉPONSE :
1. **Analyse du cas** — qualification juridique de la situation, enjeux
   identifiés.
2. **Règles applicables** — principes et obligations mobilisés
   [Source N].
3. **Application au cas** — confrontation des règles aux faits décrits.
4. **Recommandation** — les actions à mener, dans l'ordre.

{_SCOPE_RULES}

{_STYLE_COMMON}
- Longueur cible : 200 à 400 mots.
"""

SYSTEM_PROMPT_COMPARAISON = f"""{_PERSONA}
Ta spécialité ici : comparer rigoureusement des notions, régimes ou
options (ex. : registre vs AIPD, consentement vs intérêt légitime).

{_CITATION_RULES}
- La synthèse comparative issue de ton raisonnement se présente sans tag.

PLAN DE RÉPONSE :
1. **Définitions** — chaque notion définie séparément, avec [Source N].
2. **Comparaison structurée** — tableau Markdown ou liste parallèle :
   critères de distinction, conditions d'application, portée, limites.
3. **Conclusion opérationnelle** — dans quelle situation retenir l'une
   ou l'autre.

{_STYLE_COMMON}
- Longueur cible : 200 à 400 mots ; un tableau Markdown est bienvenu
  quand il clarifie.
"""

SYSTEM_PROMPT_LISTE = f"""{_PERSONA}
Ta spécialité ici : produire des énumérations complètes et détaillées
(obligations, mentions, exceptions, catégories…).

{_CITATION_RULES}
- Ici la règle de citation s'applique À CHAQUE ÉLÉMENT de la liste.

PLAN DE RÉPONSE :
1. **Cadre** — une ou deux phrases situant la liste [Source N].
2. **Liste complète** — numérotée ; chaque entrée porte le terme clé en
   **gras**, un développement suffisant (pas un simple intitulé) et sa
   citation.
3. **Note de complétude** — si les sources ne garantissent pas
   l'exhaustivité, le dire explicitement plutôt que de tronquer en
   silence.

{_STYLE_COMMON}
- Pour ce type de question l'exhaustivité prime sur la concision.
"""

SYSTEM_PROMPT_REFUS = f"""{_PERSONA}

La question reçue est hors périmètre ou cherche à contourner la loi.
Ta réponse est un REFUS — ferme, sans complaisance ni aide déguisée.

CONDUITE À TENIR :
1. Contournement d'une obligation RGPD (éviter une AIPD, esquiver le
   consentement, masquer une violation…) : rappelle que ces obligations
   sont impératives et qu'aucun contournement n'existe ; mentionne le
   plafond de sanction administrative (20 M€ ou 4 % du chiffre
   d'affaires mondial, art. 83 RGPD). Ne propose NI alternative, NI
   astuce, NI méthodologie.
2. Demande pénalement répréhensible (intrusion informatique, captation
   ou détournement de données, usurpation d'identité, espionnage) :
   refus catégorique, avec rappel des sanctions pénales françaises —
   accès frauduleux à un système (art. 323-1 C. pénal : 3 ans, 100 000 €),
   collecte frauduleuse de données (art. 226-18 : 5 ans, 300 000 €),
   détournement de finalité (art. 226-21 : 5 ans, 300 000 €) — et de
   l'exposition à des poursuites.
3. Simple hors-sujet (cuisine, sport, technique sans données
   personnelles) : une seule phrase — « Cette question ne relève pas du
   périmètre RGPD/CNIL couvert par mes sources. » — et rien de plus.
4. Dans tous les cas : pas de « je comprends votre démarche », pas de
   proposition de reformulation, pas d'aide complémentaire.

FORMAT : bref, ferme, étayé par les sanctions applicables.
"""

INTENT_SYSTEM_PROMPTS: dict[str, str] = {
    "factuel": BASE_SYSTEM_PROMPT,
    "methodologique": SYSTEM_PROMPT_METHODOLOGIQUE,
    "organisationnel": SYSTEM_PROMPT_ORGANISATIONNEL,
    "cas_pratique": SYSTEM_PROMPT_CAS_PRATIQUE,
    "comparaison": SYSTEM_PROMPT_COMPARAISON,
    "liste_exhaustive": SYSTEM_PROMPT_LISTE,
    "refus": SYSTEM_PROMPT_REFUS,
}

INTENT_INSTRUCTIONS: dict[str, str] = {
    "factuel": (
        "Donne la réponse factuelle précise en premier (délai, seuil, "
        "définition), puis le détail utile. Reste concis."
        "{negative_instruction}"
    ),
    "methodologique": (
        "Structure ta réponse en étapes numérotées et actionnables, dans "
        "l'ordre opérationnel. Mentionne les livrables attendus."
        "{negative_instruction}"
    ),
    "organisationnel": (
        "Précise les rôles et responsabilités de chaque acteur "
        "(responsable de traitement, DPO, sous-traitant, direction)."
        "{negative_instruction}"
    ),
    "comparaison": (
        "Présente d'abord chaque notion, puis un tableau ou une liste des "
        "différences et points communs, puis une conclusion pratique."
        "{negative_instruction}"
    ),
    "cas_pratique": (
        "Qualifie juridiquement la situation décrite, puis déroule les "
        "obligations applicables et les actions recommandées."
        "{negative_instruction}"
    ),
    "liste_exhaustive": (
        "Fournis une énumération complète sous forme de liste à puces ; "
        "signale explicitement si les sources ne permettent pas "
        "l'exhaustivité.{negative_instruction}"
    ),
    "refus": (
        "La question sort du périmètre protection des données : décline "
        "poliment et recentre sur le RGPD.{negative_instruction}"
    ),
}

USER_PROMPT_TEMPLATE = """{history}Contexte documentaire :
{context}

Instructions spécifiques : {instructions}

Question : {question}

Réponse (avec citations [Source N]) :"""

MAP_PROMPT = """À partir de l'extrait documentaire suivant, note tout
élément utile pour répondre à la question. Conserve les références
[Source N] d'origine. Si rien n'est pertinent, réponds "RIEN".

Question : {question}

Extrait :
{chunk}

Éléments pertinents :"""

REDUCE_PROMPT = """Fusionne les notes partielles suivantes en une réponse
unique, structurée, citant les [Source N] d'origine.

Question : {question}

Notes :
{partials}

Réponse fusionnée :"""


@dataclasses.dataclass
class BuiltContext:
    system_prompt: str
    user_prompt: str
    context_text: str
    sources: list[dict]       # [{'n', 'title', 'url', 'chunk_ids'}]
    map_reduced: bool = False


class ContextBuilder:
    def __init__(
        self,
        llm: BaseLLMProvider | None = None,
        max_context_chars: int = 32_000,
        reverse_packing: bool = True,
        history_turns: int = 5,
        map_batch_chars: int = 5_000,
    ):
        self.llm = llm
        self.max_context_chars = max_context_chars
        self.reverse_packing = reverse_packing
        self.history_turns = history_turns
        self.map_batch_chars = map_batch_chars

    # ----------------------------------------------------------- building
    def build_context(
        self,
        question: str,
        documents: Sequence,         # RetrievedDocument list
        intent: str = "factuel",
        negative_topics: Sequence[str] = (),
        conversation_history: Sequence[dict] | None = None,
    ) -> BuiltContext:
        neg = ""
        if negative_topics:
            neg = (
                " N'aborde pas les thèmes suivants, explicitement exclus "
                f"par la question : {', '.join(negative_topics)}."
            )
        instructions = INTENT_INSTRUCTIONS.get(
            intent, INTENT_INSTRUCTIONS["factuel"]
        ).format(negative_instruction=neg)

        blocks, sources = self._format_documents(documents)
        context_text = "\n\n".join(blocks)

        map_reduced = False
        if len(context_text) > self.max_context_chars and self.llm is not None:
            context_text = self._map_reduce(question, blocks)
            map_reduced = True
        elif len(context_text) > self.max_context_chars:
            # under reverse packing the MOST relevant sources sit at the
            # TAIL (nearest the question) — truncate from the front so
            # the best documents survive, not the worst
            context_text = (
                context_text[-self.max_context_chars:]
                if self.reverse_packing
                else context_text[: self.max_context_chars]
            )

        history = self._format_history(conversation_history)
        user_prompt = USER_PROMPT_TEMPLATE.format(
            history=history,
            context=context_text,
            instructions=instructions,
            question=question,
        )
        return BuiltContext(
            system_prompt=INTENT_SYSTEM_PROMPTS.get(
                intent, BASE_SYSTEM_PROMPT),
            user_prompt=user_prompt,
            context_text=context_text,
            sources=sources,
            map_reduced=map_reduced,
        )

    def _format_documents(self, documents: Sequence):
        """Number sources 1..N by relevance; pack least-relevant FIRST
        (reverse packing → best source nearest the question)."""
        sources = []
        numbered_blocks = []
        for n, doc in enumerate(documents, start=1):
            parts = []
            for chunk in doc.chunks:
                heading = chunk.heading
                text = chunk.text
                parts.append(f"### {heading}\n{text}" if heading else text)
            body = "\n\n".join(parts)
            title = doc.title or doc.doc_key
            numbered_blocks.append(
                f"[Source {n}] {title}\n{body}"
            )
            sources.append({
                "n": n,
                "title": title,
                "url": getattr(doc.chunks[0], "source_url", ""),
                "chunk_ids": [c.chunk_id for c in doc.chunks],
            })
        blocks = (
            list(reversed(numbered_blocks))
            if self.reverse_packing
            else numbered_blocks
        )
        return blocks, sources

    def _format_history(self, history) -> str:
        if not history:
            return ""
        turns = list(history)[-self.history_turns :]
        lines = []
        for turn in turns:
            role = "Utilisateur" if turn.get("role") == "user" else "Assistant"
            lines.append(f"{role} : {turn.get('content', '')}")
        return "Historique de la conversation :\n" + "\n".join(lines) + "\n\n"

    # --------------------------------------------------------- map-reduce
    def _map_reduce(self, question: str, blocks: list[str]) -> str:
        batches: list[str] = []
        cur = ""
        for block in blocks:
            if cur and len(cur) + len(block) > self.map_batch_chars:
                batches.append(cur)
                cur = block
            else:
                cur = f"{cur}\n\n{block}" if cur else block
        if cur:
            batches.append(cur)

        partials = []
        for batch in batches:
            resp = self.llm.generate(
                MAP_PROMPT.format(question=question, chunk=batch),
                temperature=0.0,
            )
            if resp.ok and resp.text.strip() and \
                    resp.text.strip().upper() != "RIEN":
                partials.append(resp.text.strip())
        if not partials:
            joined = "\n\n".join(blocks)
            return (joined[-self.max_context_chars:]
                    if self.reverse_packing
                    else joined[: self.max_context_chars])
        resp = self.llm.generate(
            REDUCE_PROMPT.format(question=question,
                                 partials="\n\n---\n\n".join(partials)),
            temperature=0.0,
        )
        if resp.ok and resp.text.strip():
            return resp.text.strip()
        return "\n\n".join(partials)[: self.max_context_chars]

    # ------------------------------------------------- response formatting
    def format_response_with_sources(
        self, answer: str, sources: list[dict]
    ) -> tuple[str, list[dict]]:
        """Renumber cited sources to dense 1..K (cited-only), append a
        'Sources' section. Citation renumbering via placeholder pass so
        overlapping rewrites can't collide (reference :783-799)."""
        cited = []
        for c in extract_citations(answer):
            if c not in cited and 1 <= c <= len(sources):
                cited.append(c)
        if not cited:
            return answer, []

        mapping = {old: new for new, old in enumerate(cited, start=1)}

        def to_placeholder(m: re.Match) -> str:
            nums = [int(x) for x in re.findall(r"\d+", m.group(1))]
            kept = [mapping[n] for n in nums if n in mapping]
            if not kept:
                return ""
            return "\x00SRC" + ",".join(map(str, kept)) + "\x00"

        # the ONE citation pattern — shared with extract_citations so the
        # "which sources are cited" decision and this rewrite can't drift
        from .validators import _CITATION_RE

        tmp = _CITATION_RE.sub(to_placeholder, answer)

        def from_placeholder(m: re.Match) -> str:
            nums = m.group(1).split(",")
            label = "Source" if len(nums) == 1 else "Sources"
            return f"[{label} {', '.join(nums)}]"

        renumbered = re.sub("\x00SRC([0-9,]+)\x00", from_placeholder, tmp)

        used = []
        for old in cited:
            src = dict(sources[old - 1])
            src["n"] = mapping[old]
            used.append(src)

        lines = ["", "---", "**Sources :**"]
        for src in used:
            url = f" — {src['url']}" if src.get("url") else ""
            lines.append(f"{src['n']}. {src['title']}{url}")
        return renumbered + "\n" + "\n".join(lines), used


def fix_markdown_formatting(text: str) -> str:
    """Markdown cleanup pass (reference `_fix_markdown_formatting`
    :595-661): normalize bullet markers, collapse >2 blank lines, ensure
    space after heading hashes, balance unclosed bold markers."""
    text = re.sub(r"^[•●▪]\s*", "- ", text, flags=re.MULTILINE)
    text = re.sub(r"^(#{1,6})([^#\s])", r"\1 \2", text, flags=re.MULTILINE)
    text = re.sub(r"\n{3,}", "\n\n", text)
    if text.count("**") % 2 == 1:
        text += "**"
    return text.strip()
