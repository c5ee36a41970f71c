"""French lexical tokenization for the sparse (BM25) arm.

Behavior-parity role of the reference's accent-aware BM25 tokenizer
(`src/rag/bm25_index.py:22-49`): lowercase, keep hyphenated compounds and
article numbers ("article 28", "32-1") intact, drop stopwords and
one-character tokens. Independent implementation; stopword list is the
standard French function-word set.

Used host-side when building the ELL impact matrix (ops.sparse) and when
forming query term lists.
"""

from __future__ import annotations

import re
import unicodedata

FRENCH_STOPWORDS = frozenset("""
le la les un une des de du au aux et ou mais donc or ni car que qui quoi dont
ce cette ces cet se sa son ses leur leurs mon ma mes ton ta tes notre nos
votre vos il elle ils elles nous vous je tu on ne pas plus moins tres dans
par pour sur sous avec sans chez vers entre jusque pendant avant apres est
sont etre avoir fait faire a ont aussi comme si alors ainsi tout tous toute
toutes meme memes autre autres peut peuvent doit doivent etait etaient sera
seront cela ca y en l d s n qu j c m t
""".split())

# words (incl. hyphenated compounds and digit refs like 32-1), kept whole
_TOKEN_RE = re.compile(r"[a-z0-9]+(?:-[a-z0-9]+)*", re.UNICODE)


_LIGATURES = str.maketrans({"œ": "oe", "Œ": "OE", "æ": "ae", "Æ": "AE",
                            "ß": "ss"})


def strip_accents(text: str) -> str:
    # NFD leaves ligatures intact (œ is not a combining sequence), so they
    # are folded explicitly — otherwise "cœur" would tokenize as "ur".
    text = text.translate(_LIGATURES)
    return "".join(
        c for c in unicodedata.normalize("NFD", text)
        if unicodedata.category(c) != "Mn"
    )


def tokenize_french_text(text: str) -> list[str]:
    """Lowercased, accent-stripped lexical tokens with stopwords removed."""
    norm = strip_accents(text.lower())
    out = []
    for tok in _TOKEN_RE.findall(norm):
        if len(tok) <= 1 and not tok.isdigit():
            continue
        if tok in FRENCH_STOPWORDS:
            continue
        out.append(tok)
    return out
