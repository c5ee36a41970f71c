"""Content-hash corpus deduplication.

Role parity with `src/processing/deduplicate_corpus.py` (strategy
docstring :1-23): MD5 over extracted text content for HTML (so boilerplate
differences don't defeat dedup), raw-bytes hash for binaries; the
canonical copy is the shortest https URL; duplicates are *archived*
(listed), never deleted. Removed ~51% of the reference corpus.
"""

from __future__ import annotations

import hashlib
from typing import Mapping, Sequence


def content_hash(text_or_bytes) -> str:
    if isinstance(text_or_bytes, str):
        normalized = " ".join(text_or_bytes.split()).lower()
        return hashlib.md5(normalized.encode()).hexdigest()
    return hashlib.md5(text_or_bytes).hexdigest()


def _canonical_rank(url: str) -> tuple:
    return (0 if url.startswith("https://") else 1, len(url), url)


def deduplicate(
    docs: Sequence[Mapping],
) -> tuple[list[dict], list[dict]]:
    """docs: [{'doc_id', 'url', 'content' (str|bytes), ...}] →
    (kept, archived) — archived entries carry `duplicate_of`."""
    by_hash: dict[str, list[dict]] = {}
    for doc in docs:
        h = content_hash(doc["content"])
        by_hash.setdefault(h, []).append(dict(doc))
    kept, archived = [], []
    for h, group in by_hash.items():
        group.sort(key=lambda d: _canonical_rank(d.get("url", "")))
        canonical = group[0]
        canonical["content_hash"] = h
        kept.append(canonical)
        for dup in group[1:]:
            dup["duplicate_of"] = canonical["doc_id"]
            dup["content_hash"] = h
            archived.append(dup)
    return kept, archived
