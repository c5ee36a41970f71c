"""BM25 Okapi over a chunk corpus, as the deployment's sparse arm defines
it, in NumPy and plain Python.

Tokens: lower case, accents and ligatures folded, words with their
hyphenated compounds kept whole, French stopwords and one-letter
non-digit tokens dropped. Statistics: rank_bm25's (k1 1.5, b 0.75; idf
ln((N − df + 0.5) / (df + 0.5)), a negative idf floored to 0.25 × the mean
idf). Each chunk keeps its `width` most frequent terms, each with its
document-side impact
tf·(k1+1) / (tf + k1·(1 − b + b·dl/avgdl)). A query's terms are its
distinct tokens found in the vocabulary, at their idf, then the
vocabulary's terms that share a 6-letter prefix with a query token, at
half their idf, at most `max_terms` in all; a chunk scores the sum of
weight × impact over the query terms it keeps.

Among terms of equal count a chunk keeps first those seen first: in the
whole corpus (`ties="corpus"`, the C++ indexer's rule) or in the chunk
(`ties="chunk"`, the Python indexer's). The two indexers differ there,
so the reference follows the one the index was built by.
"""

from __future__ import annotations

import bisect
import functools
import math
import re
import unicodedata
from collections import Counter
from typing import Sequence

import numpy as np

STOPWORDS = frozenset("""
le la les un une des de du au aux et ou mais donc or ni car que qui quoi dont
ce cette ces cet se sa son ses leur leurs mon ma mes ton ta tes notre nos
votre vos il elle ils elles nous vous je tu on ne pas plus moins tres dans
par pour sur sous avec sans chez vers entre jusque pendant avant apres est
sont etre avoir fait faire a ont aussi comme si alors ainsi tout tous toute
toutes meme memes autre autres peut peuvent doit doivent etait etaient sera
seront cela ca y en l d s n qu j c m t
""".split())
TOKEN_RE = re.compile(r"[a-z0-9]+(?:-[a-z0-9]+)*", re.UNICODE)
LIGATURES = str.maketrans({"œ": "oe", "Œ": "OE", "æ": "ae", "Æ": "AE",
                           "ß": "ss"})
K1, B, EPSILON = 1.5, 0.75, 0.25
PREFIX, NEIGHBOR_WEIGHT = 6, 0.5


@functools.lru_cache(maxsize=1 << 16)
def word_tokens(word: str) -> tuple[str, ...]:
    norm = "".join(c for c in unicodedata.normalize(
        "NFD", word.lower().translate(LIGATURES))
        if unicodedata.category(c) != "Mn")
    return tuple(t for t in TOKEN_RE.findall(norm)
                 if (len(t) > 1 or t.isdigit()) and t not in STOPWORDS)


def tokens(text: str) -> list[str]:
    """No token spans white space, so a text's tokens are its
    white-space-separated words' tokens, each word's worked out once."""
    return [t for w in text.split() for t in word_tokens(w)]


class Corpus:
    def __init__(self, texts: Sequence[str], width: int,
                 ties: str = "corpus"):
        docs = [tokens(t) for t in texts]
        df: Counter = Counter()
        first: dict[str, int] = {}
        for d in docs:
            df.update(set(d))
            for t in d:
                first.setdefault(t, len(first))
        self.terms = sorted(df)
        self.vocab = {t: i for i, t in enumerate(self.terms)}
        n = len(docs)
        idf = np.asarray([math.log((n - df[t] + 0.5) / (df[t] + 0.5))
                          for t in self.terms], np.float64)
        idf[idf < 0] = EPSILON * idf.mean()
        self.idf = idf
        dl = np.asarray([len(d) for d in docs], np.float64)
        avgdl = dl.sum() / max(n, 1)
        # per term: the chunks that keep it, and its impact there
        self.postings: dict[int, list[tuple[int, float]]] = {}
        for row, d in enumerate(docs):
            norm = K1 * (1 - B + B * dl[row] / avgdl)
            counts = Counter(d).items()
            if ties == "corpus":
                kept = sorted(counts, key=lambda kv: (-kv[1], first[kv[0]]))
            else:
                kept = sorted(counts, key=lambda kv: -kv[1])
            kept = kept[:width]
            for term, tf in kept:
                self.postings.setdefault(self.vocab[term], []).append(
                    (row, tf * (K1 + 1) / (tf + norm)))
        self.n = n

    def query_terms(self, text: str, max_terms: int = 32
                    ) -> list[tuple[int, float]]:
        out: list[tuple[int, float]] = []
        ids: set[int] = set()
        neighbors: list[str] = []
        seen: set[str] = set()
        for tok in tokens(text):
            if tok in seen:
                continue
            seen.add(tok)
            tid = self.vocab.get(tok)
            if tid is not None and tid not in ids:
                ids.add(tid)
                out.append((tid, float(self.idf[tid])))
            if len(tok) >= PREFIX:
                pre = tok[:PREFIX]
                i = bisect.bisect_left(self.terms, pre)
                while i < len(self.terms) and \
                        self.terms[i].startswith(pre):
                    if self.terms[i] != tok:
                        neighbors.append(self.terms[i])
                    i += 1
            if len(out) >= max_terms:
                break
        for term in neighbors:
            if len(out) >= max_terms:
                break
            tid = self.vocab[term]
            if tid not in ids:
                ids.add(tid)
                out.append((tid, NEIGHBOR_WEIGHT * float(self.idf[tid])))
        return out

    def scores(self, text: str, max_terms: int = 32) -> np.ndarray:
        """Every chunk's score for the query `text` (0 where no term
        matches)."""
        s = np.zeros((self.n,), np.float64)
        for tid, w in self.query_terms(text, max_terms):
            for row, imp in self.postings.get(tid, ()):
                s[row] += w * imp
        return s
