"""The hashed subword tokenizer the deployment runs without a tokenizer
file (ROADMAP C-7): NFKC, lower case, words and single punctuation marks,
each word cut into pieces of at most 4 characters, each piece FNV-1a
hashed into the vocabulary past the 4 special ids. A frozen copy, so the
reference does not read the port's ids."""

from __future__ import annotations

import re
import unicodedata

CLS, PAD, SEP, UNK, N_SPECIAL = 0, 1, 2, 3, 4
PIECE = 4
WORD_RE = re.compile(r"[\w]+|[^\w\s]", re.UNICODE)
# the power-of-two row widths a prompt is padded to (the serving front's)
BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def fnv1a(s: str) -> int:
    h = 0xCBF29CE484222325
    for ch in s.encode("utf-8"):
        h ^= ch
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def words(text: str) -> list[str]:
    return WORD_RE.findall(unicodedata.normalize("NFKC", text).lower())


def word_pieces(word: str) -> int:
    return -(-len(word) // PIECE)


def tokenize(text: str, vocab: int) -> list[int]:
    out = []
    space = vocab - N_SPECIAL
    for w in words(text):
        for i in range(0, len(w), PIECE):
            out.append(N_SPECIAL + fnv1a(w[i:i + PIECE]) % space)
    return out


def count(text: str) -> int:
    """Tokens of `text`, without the specials."""
    return sum(word_pieces(w) for w in words(text))


def bucket(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


def encode(text: str, vocab: int, max_len: int) -> list[int]:
    """[CLS] + tokens + [SEP], the tokens cut to fit `max_len`."""
    return [CLS] + tokenize(text, vocab)[:max_len - 2] + [SEP]


def generation_prompt(text: str, vocab: int, context: int,
                      max_new: int) -> list[int]:
    """A generation request's prompt ids: the row width is the bucket of
    len(text) // 3 + 2, within the context left for `max_new` tokens."""
    width = min(bucket(len(text) // 3 + 2), context - 1 - max_new)
    return encode(text, vocab, width)


def encode_pair(a: str, b: str, vocab: int, max_len: int) -> list[int]:
    """A cross-encoder pair: [CLS] a [SEP][SEP] b [SEP]; past `max_len`
    the query keeps at most a third of the budget, the passage the rest."""
    ta, tb = tokenize(a, vocab), tokenize(b, vocab)
    budget = max_len - 4
    if len(ta) + len(tb) > budget:
        keep = min(len(ta), budget // 3)
        ta, tb = ta[:keep], tb[:budget - keep]
    return [CLS] + ta + [SEP, SEP] + tb + [SEP]
