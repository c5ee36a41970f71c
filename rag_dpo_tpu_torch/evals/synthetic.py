"""Synthetic corpus + extractive generator for hermetic full-stack eval.

The reference's 90.4% benchmark needs its private 16,919-chunk CNIL index
plus live Ollama — unreproducible in CI. This module makes the 48-question
replay runnable hermetically:

* `build_synthetic_corpus(dataset)` — one relevant document per QA item,
  synthesized from its `expected_answer_summary` and
  `expected_sources_keywords`, plus distractors, so retrieval has a
  ground-truth target per question;
* `ExtractiveFakeLLM` — a deterministic generator that answers by
  extracting the context sentences sharing vocabulary with the question
  and citing their `[Source N]`. No hallucination by construction, so the
  eval exercises retrieval quality end-to-end: if retrieval surfaces the
  right document, keyword/source scores are high; if not, they drop.

Corpus versions (records carry the version; the regression gate only
compares like-for-like — evals/hermetic.py):

* v1 — each document's heading was the question verbatim plus generic
  filler distractors. Too easy twice over: BM25 nails the echoed
  heading, and the extractive generator's best "sentence" was the echo
  itself (carrying zero answer content, hence keyword scores of 0).
* v2 (current) — realistic topic-titled documents (real CNIL pages never
  restate the user's question) and NEAR-MISS distractors per item, the
  trap-hardness the reference builds its piège/hors-périmètre categories
  around (its `eval/qa_dataset.json`):
    - an "archive" twin: same body with every number perturbed (wrong
      delays/amounts/articles) — retrieval rank decides whether the
      extractive answer quotes the right or the wrong figures;
    - a topic blend: this item's title + another item's body — title
      match, wrong content;
    - a nav page: generic filler + this item's keyword footer — attracts
      lexical retrieval without carrying any answer.
"""

from __future__ import annotations

import re

from ..providers.fake import FakeLLMProvider
from ..tokenize.french import tokenize_french_text

CORPUS_VERSION = 2

_NUM_RE = re.compile(r"\d+")


def _perturb_numbers(text: str) -> str:
    """Deterministically replace every number with a different,
    similarly-sized one ("72 heures" → "96 heures", "art. 35" →
    "art. 59") — a near-miss page carrying WRONG figures."""
    def rep(m):
        n = int(m.group(0))
        if n < 10:
            return str(n + 3)
        if n < 100:
            return str(n + 24)
        return str(n + 111)
    return _NUM_RE.sub(rep, text)


def _topic_title(item: dict) -> str:
    kws = item.get("expected_sources_keywords") or []
    if kws:
        return kws[0].title()
    # fall back to the summary's first few content words, never the
    # question (v1's echo defect)
    words = (item.get("expected_answer_summary", "") or
             item["question"]).split()
    return " ".join(words[:6]).rstrip(".,;:")


_FILLER = [
    "La commission publie chaque année un rapport d'activité détaillant "
    "ses missions d'information et de contrôle.",
    "Le site propose des fiches pratiques destinées aux professionnels "
    "et aux particuliers sur des sujets variés.",
    "Des webinaires de sensibilisation sont organisés régulièrement à "
    "destination des organismes publics et privés.",
    "L'actualité réglementaire européenne fait l'objet d'une veille "
    "publiée sur le portail institutionnel.",
]


def build_synthetic_corpus(dataset: list[dict],
                           n_distractors: int = 20,
                           version: int = CORPUS_VERSION,
                           near_miss_per_item: int = 3) -> list[dict]:
    if version == 1:
        return _build_corpus_v1(dataset, n_distractors)
    chunks = []
    n = len(dataset)
    for i, item in enumerate(dataset):
        body = item.get("expected_answer_summary", "")
        kws = item.get("expected_sources_keywords") or []
        refs = item.get("reference_articles") or []
        title = _topic_title(item)
        text = f"{title}. {body}"
        if refs:
            text += " Références : " + ", ".join(refs) + "."
        if kws:
            text += " Mots-clés : " + ", ".join(kws) + "."
        chunks.append({
            "chunk_id": f"qa_{item['id']}",
            "text": text,
            "heading": title,
            "title": title,
            "doc_key": f"cnil.fr/{item['id']}",
            "source_url": f"https://cnil.fr/fr/{item['id']}",
            "source": "CNIL",
            "nature": "DOCTRINE",
        })
        if near_miss_per_item >= 1:
            # archive twin: same topic, WRONG numbers/articles
            twin = _perturb_numbers(body)
            twin_refs = _perturb_numbers(", ".join(refs)) if refs else ""
            ttl = f"Ancienne recommandation : {title}"
            ttext = f"{ttl}. {twin}"
            if twin_refs:
                ttext += " Références : " + twin_refs + "."
            chunks.append({
                "chunk_id": f"twin_{item['id']}",
                "text": ttext,
                "heading": ttl,
                "title": ttl,
                "doc_key": f"cnil.fr/archive/{item['id']}",
                "source_url":
                    f"https://cnil.fr/fr/archive/{item['id']}",
                "source": "CNIL",
                "nature": "ARCHIVE",
            })
        if near_miss_per_item >= 2:
            # topic blend: THIS item's title+keywords, ANOTHER's body
            j = (i + 17) % n
            other_body = dataset[j].get("expected_answer_summary", "")
            btext = f"{title} : notions connexes. {other_body}"
            if kws:
                btext += " Mots-clés : " + ", ".join(kws) + "."
            chunks.append({
                "chunk_id": f"blend_{item['id']}",
                "text": btext,
                "heading": f"{title} : notions connexes",
                "title": f"{title} : notions connexes",
                "doc_key": f"cnil.fr/blend/{item['id']}",
                "source_url": f"https://cnil.fr/fr/blend/{item['id']}",
                "source": "CNIL",
                "nature": "MIXTE",
            })
        if near_miss_per_item >= 3:
            # nav page: filler prose + this item's keyword footer
            ntext = (_FILLER[i % len(_FILLER)] +
                     (" Mots-clés : " + ", ".join(kws) + "."
                      if kws else ""))
            chunks.append({
                "chunk_id": f"nav_{item['id']}",
                "text": ntext,
                "heading": "Informations générales",
                "title": f"Navigation : {title}",
                "doc_key": f"cnil.fr/nav/{item['id']}",
                "source_url": f"https://cnil.fr/fr/nav/{item['id']}",
                "source": "CNIL",
                "nature": "MIXTE",
            })
    chunks.extend(_generic_distractors(n_distractors))
    return chunks


def _generic_distractors(n_distractors: int) -> list[dict]:
    out = []
    for i in range(n_distractors):
        text = _FILLER[i % len(_FILLER)] + f" (édition {2020 + i % 6})"
        out.append({
            "chunk_id": f"distract_{i}",
            "text": text,
            "heading": "Informations générales",
            "title": f"Page générale {i}",
            "doc_key": f"cnil.fr/general/{i}",
            "source_url": f"https://cnil.fr/fr/general/{i}",
            "source": "CNIL",
            "nature": "MIXTE",
        })
    return out


def _build_corpus_v1(dataset: list[dict],
                     n_distractors: int = 20) -> list[dict]:
    """The round-1..3 corpus, kept for the distractor-scaling study:
    question-echo headings + generic filler only."""
    chunks = []
    for item in dataset:
        body = item.get("expected_answer_summary", "")
        kws = item.get("expected_sources_keywords") or []
        refs = item.get("reference_articles") or []
        heading = item["question"].rstrip(" ?")
        text = f"{heading}. {body}"
        if refs:
            text += " Références : " + ", ".join(refs) + "."
        if kws:
            text += " Mots-clés : " + ", ".join(kws) + "."
        title = (kws[0].title() if kws else item["question"][:60])
        chunks.append({
            "chunk_id": f"qa_{item['id']}",
            "text": text,
            "heading": title,
            "title": title,
            "doc_key": f"cnil.fr/{item['id']}",
            "source_url": f"https://cnil.fr/fr/{item['id']}",
            "source": "CNIL",
            "nature": "DOCTRINE",
        })
    chunks.extend(_generic_distractors(n_distractors))
    return chunks


_SOURCE_BLOCK = re.compile(r"\[Source (\d+)\]\s*([^\n]*)\n(.*?)(?=\n\[Source \d+\]|\Z)",
                           re.DOTALL)
_QUESTION_RE = re.compile(r"Question\s*:\s*(.+?)(?:\n|$)")

# light French suffix stripping for the overlap sets — longest first.
# Real LLMs match across number/gender ("donnée personnelle" answers a
# question about "données ... personne"); without this the extractor
# returns "cannot answer" on pure morphology mismatches.
_FR_SUFFIXES = ("issements", "issement", "atrices", "atrice", "ements",
                "ement", "elles", "euses", "ables", "istes", "ales",
                "elle", "euse", "able", "iste", "ives", "aux", "ees",
                "ale", "ive", "es", "ee", "e", "s")


def _stem_fr(tok: str) -> str:
    if tok.isdigit():
        return tok
    for suf in _FR_SUFFIXES:
        if tok.endswith(suf) and len(tok) - len(suf) >= 3:
            return tok[: -len(suf)]
    return tok


def _term_set(text: str) -> set[str]:
    return {_stem_fr(t) for t in tokenize_french_text(text)}


class ExtractiveFakeLLM(FakeLLMProvider):
    """Deterministic extractive answering over the provided context.

    Models how a grounded LLM actually answers, three rules that matter
    for what the hermetic scores measure:

    * sentences whose content words are a subset of the question's are
      SKIPPED — an answer that restates the question carries no
      information (v1's dominant failure: the corpus heading echoed the
      question and won the overlap ranking with keyword scores of 0);
    * tag footers ("Mots-clés : …") are skipped — an assistant does not
      quote navigation metadata;
    * ties between near-identical sentences (a true document vs its
      digit-perturbed archive twin) resolve by CONTEXT ORDER, i.e. by
      retrieval rank — so answer quality tracks ranking quality, which
      is exactly the axis the hermetic eval exists to measure.
    """

    model_name = "fake-extractive"

    # out-of-scope / illegal-intent signals: flagging these is the
    # EASIEST task a real instruction-following LLM performs (the
    # reference's refus category exists because Mistral-Nemo does it
    # reliably); matched against the QUESTION only — the intent
    # prompt's own instructions legitimately mention examples like
    # "météo, cuisine"
    _REFUS_SIGNALS = ("pirater", "piratage", "hacker", "hacking",
                      "intrusion informatique", "contourner",
                      "antivirus", "meteo", "météo", "recette",
                      "cuisine", "football", "horoscope")

    _REFUSAL_TEXT = (
        "Cette demande est hors périmètre RGPD/CNIL : il n'est pas "
        "possible de contourner les obligations légales, et aucune "
        "recommandation de produit ou d'aide à une action illégale ne "
        "sera fournie. Toute tentative expose à des sanctions pénales "
        "et administratives."
    )

    def _auto(self, prompt: str, system: str, json_mode: bool) -> str:
        low = (prompt + "\n" + (system or "")).lower()
        if '"intent"' in prompt and "json" in low:
            questions = _QUESTION_RE.findall(prompt)
            q_low = (questions[-1] if questions else "").lower()
            if any(s in q_low for s in self._REFUS_SIGNALS):
                import json as _json
                return _json.dumps({
                    "intent": "refus", "topics": [],
                    "negative_topics": [], "wants_sources": False,
                    "is_comparison": False,
                })
            return super()._auto(prompt, system, json_mode)
        if system and "un REFUS" in system:
            # the pipeline routed intent=refus and asked for a refusal
            # (SYSTEM_PROMPT_REFUS) — an instruction-following LLM
            # complies; extraction would be the WRONG behavior here
            return self._REFUSAL_TEXT
        if "[Source" in prompt and "Question" in prompt:
            return self._answer(prompt)
        return super()._auto(prompt, system, json_mode)

    def _answer(self, prompt: str) -> str:
        # find the LAST "Question :" occurrence (history may contain more)
        questions = _QUESTION_RE.findall(prompt)
        question = questions[-1] if questions else ""
        q_terms = _term_set(question)

        # parse ONLY the context region: the last source block's body
        # would otherwise swallow the prompt tail ("Instructions
        # spécifiques : …", "Question : …") and the question line
        # itself becomes the best-"overlapping" extraction candidate
        context_region = prompt
        for marker in ("\nInstructions spécifiques", "\nQuestion :"):
            cut = context_region.rfind(marker)
            if cut != -1:
                context_region = context_region[:cut]

        scored: list[tuple[float, int, str, int]] = []
        order = 0
        for m in _SOURCE_BLOCK.finditer(context_region):
            n = int(m.group(1))
            title_terms = _term_set(m.group(2) or "")
            # document-level topical match: a doc titled "Obligations"
            # answers "quelles obligations…" even when its body is a
            # bare enumeration sharing no word with the question (the
            # LLM behavior being modeled: answer from the doc the
            # retriever ranked for this topic, not only from sentences
            # that lexically echo the question)
            t_overlap = (len(q_terms & title_terms)
                         / (len(q_terms) + 1.0)) if q_terms else 0.0
            block = m.group(3) or ""
            for sentence in re.split(r"(?<=[.!?])\s+", block):
                if sentence.lstrip().lower().startswith("mots-clés"):
                    continue
                s_terms = _term_set(sentence)
                if not s_terms or s_terms <= q_terms:
                    continue  # empty or pure question echo
                if len(s_terms) < 4:
                    # title fragments / one-word lines ("Aipd.") are
                    # not answering sentences — without this floor a
                    # 1-term title scores overlap/sqrt(1)=1.0 and
                    # outranks every real content sentence
                    continue
                overlap = len(q_terms & s_terms)
                score = (overlap / (len(s_terms) ** 0.5)
                         + 0.3 * t_overlap)
                if score > 0:
                    order += 1
                    scored.append((score, n, sentence.strip(), order))
        # stable tie-break by context position = retrieval rank
        scored.sort(key=lambda x: (-x[0], x[3]))
        if not scored:
            return ("Les documents fournis ne permettent pas de répondre "
                    "précisément à cette question.")
        parts = []
        seen_sentences: set[str] = set()
        for _, n, sentence, _o in scored[:4]:
            if sentence in seen_sentences:
                continue
            seen_sentences.add(sentence)
            parts.append(f"{sentence} [Source {n}]")
        return " ".join(parts)
