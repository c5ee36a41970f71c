"""Deterministic offline tokenizer (hashing subwords into a fixed vocab).

The production path uses the HF XLM-R sentencepiece tokenizer (tokenize.hf);
this one exists because the build/test environment is zero-egress with no
tokenizer files. It is *deterministic and collision-stable*: the same text
always maps to the same id sequence, so index build + query encode are
mutually consistent — exactly what retrieval tests and synthetic benchmarks
need. Words are split to ≤4-char pieces and FNV-1a hashed into the vocab.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Sequence

from .base import Encoded, pad_batch

_WORD_RE = re.compile(r"[\w]+|[^\w\s]", re.UNICODE)


def _fnv1a(s: str) -> int:
    h = 0xCBF29CE484222325
    for ch in s.encode("utf-8"):
        h ^= ch
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _normalize(text: str) -> str:
    return unicodedata.normalize("NFKC", text).lower()


class HashedTokenizer:
    # special ids follow the XLM-R layout so models are config-compatible
    cls_id = 0
    pad_id = 1
    sep_id = 2
    unk_id = 3
    n_special = 4

    def __init__(self, vocab_size: int = 30_000, piece_len: int = 4):
        self.vocab_size = vocab_size
        self.piece_len = piece_len

    def _word_pieces(self, word: str) -> list[int]:
        pieces = [
            word[i : i + self.piece_len]
            for i in range(0, len(word), self.piece_len)
        ]
        space = self.vocab_size - self.n_special
        return [
            self.n_special + (_fnv1a(p) % space) for p in pieces
        ]

    def tokenize(self, text: str) -> list[int]:
        ids: list[int] = []
        for w in _WORD_RE.findall(_normalize(text)):
            ids.extend(self._word_pieces(w))
        return ids

    def encode_batch(self, texts: Sequence[str], max_len: int) -> Encoded:
        seqs = [
            [self.cls_id] + self.tokenize(t)[: max_len - 2] + [self.sep_id]
            for t in texts
        ]
        return pad_batch(seqs, max_len, self.pad_id)

    def encode_pairs(
        self, pairs: Sequence[tuple[str, str]], max_len: int
    ) -> Encoded:
        seqs = []
        for a, b in pairs:
            ta = self.tokenize(a)
            tb = self.tokenize(b)
            budget = max_len - 4  # cls + 2×sep + sep
            if len(ta) + len(tb) > budget:
                keep_a = min(len(ta), budget // 3)
                ta = ta[:keep_a]
                tb = tb[: budget - keep_a]
            seqs.append(
                [self.cls_id] + ta + [self.sep_id, self.sep_id] + tb
                + [self.sep_id]
            )
        return pad_batch(seqs, max_len, self.pad_id)
