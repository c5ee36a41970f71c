"""Columnar metadata store + filter compilation to mask vectors.

Replaces ChromaDB's SQLite-backed metadata `where` filtering (SURVEY.md
§2.4). The reference's 20-field chunk schema (`create_chromadb_index.py:
339-360`) and its `$and`/`$or`/`$in`/`$eq`/`$ne` filter trees — e.g. the
enterprise-tag `$or` filter built in `src/rag/pipeline.py:35-71` — become
numpy columns on host, compiled per query into ONE boolean mask [N] that
the device applies before top-k. Filtering therefore costs a vector mask,
not an index traversal, and composes with any scoring arm.

Columns are typed:
* categorical (str → small-int codes + vocab)
* bool
* numeric (f32)
* set-valued categoricals (e.g. `natures`, `sectors`) stored as bitsets
  over a small vocabulary — `$contains` membership is a bitwise AND.
"""

from __future__ import annotations

import json
from typing import Any, Mapping, Sequence

import numpy as np


def _as_float(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


class MetadataStore:
    def __init__(self):
        self._n = 0
        self._cat: dict[str, tuple[list[str], dict[str, int], np.ndarray]] = {}
        self._bool: dict[str, np.ndarray] = {}
        self._num: dict[str, np.ndarray] = {}
        self._set: dict[str, tuple[list[str], dict[str, int], np.ndarray]] = {}
        self._docs: list[dict[str, Any]] = []  # raw per-row payload

    def __len__(self) -> int:
        return self._n

    # ------------------------------------------------------------- build
    def append(self, rows: Sequence[Mapping[str, Any]]):
        """Append metadata rows. Unknown keys become columns on the fly;
        missing values default (cat: '', bool: False, num: nan, set: ∅)."""
        start = self._n
        add = len(rows)
        self._n += add
        self._docs.extend(dict(r) for r in rows)

        keys: set[str] = set()
        for r in rows:
            keys.update(r.keys())
        for key in keys | set(self._cat) | set(self._bool) | set(self._num) \
                | set(self._set):
            values = [r.get(key) for r in rows]
            self._append_column(key, values, start, add)

    def _family(self, key, probe) -> str:
        """Column family for `key`: an EXISTING column always wins —
        routing by value type alone lets a key whose type drifts (e.g.
        'year': '2020' then 2021) land in a second family, leaving the
        first column stale/length-mismatched (review finding)."""
        if key in self._set:
            return "set"
        if key in self._bool:
            return "bool"
        if key in self._num:
            return "num"
        if key in self._cat:
            return "cat"
        if isinstance(probe, (list, tuple, set)):
            return "set"
        if isinstance(probe, bool):
            return "bool"
        if isinstance(probe, (int, float)):
            return "num"
        return "cat"

    def _append_column(self, key, values, start, add):
        probe = next((v for v in values if v is not None), None)
        family = self._family(key, probe)
        if family == "set":
            vocab, lookup, codes = self._set.get(
                key, ([], {}, np.zeros((start,), np.int64))
            )
            new = np.zeros((add,), np.int64)
            for i, v in enumerate(values):
                bits = 0
                for item in (v or ()):
                    item = str(item)
                    if item not in lookup:
                        if len(vocab) >= 63:
                            continue  # bitset capacity; overflow ignored
                        lookup[item] = len(vocab)
                        vocab.append(item)
                    bits |= 1 << lookup[item]
                new[i] = bits
            self._set[key] = (vocab, lookup, np.concatenate([codes, new]))
        elif family == "bool":
            col = self._bool.get(key, np.zeros((start,), bool))
            new = np.array([bool(v) for v in values], dtype=bool)
            self._bool[key] = np.concatenate([col, new])
        elif family == "num":
            col = self._num.get(key, np.full((start,), np.nan, np.float32))
            new = np.array(
                [np.nan if v is None else _as_float(v) for v in values],
                dtype=np.float32,
            )
            self._num[key] = np.concatenate([col, new])
        else:
            vocab, lookup, codes = self._cat.get(
                key, ([""], {"": 0}, np.zeros((start,), np.int32))
            )
            new = np.zeros((add,), np.int32)
            for i, v in enumerate(values):
                v = "" if v is None else str(v)
                if v not in lookup:
                    lookup[v] = len(vocab)
                    vocab.append(v)
                new[i] = lookup[v]
            self._cat[key] = (vocab, lookup, np.concatenate([codes, new]))

    def update(self, pos: int, doc: Mapping[str, Any]):
        """Rewrite row `pos` in place — the raw payload AND every columnar
        filter array, so `compile_filter`/`eq_mask` never evaluate a
        where-filter against stale values after an upsert (advisor
        finding, round 1). Keys absent from `doc` reset to the column
        default ('', False, nan, ∅)."""
        self._docs[pos] = dict(doc)
        for key in set(doc) | set(self._cat) | set(self._bool) \
                | set(self._num) | set(self._set):
            value = doc.get(key)
            family = self._family(key, value)
            if family == "set":
                vocab, lookup, codes = self._set.get(
                    key, ([], {}, np.zeros((self._n,), np.int64))
                )
                bits = 0
                for item in (value or ()):
                    item = str(item)
                    if item not in lookup:
                        if len(vocab) >= 63:
                            continue
                        lookup[item] = len(vocab)
                        vocab.append(item)
                    bits |= 1 << lookup[item]
                codes[pos] = bits
                self._set[key] = (vocab, lookup, codes)
            elif family == "bool":
                col = self._bool.setdefault(
                    key, np.zeros((self._n,), bool))
                col[pos] = bool(value)
            elif family == "num":
                col = self._num.setdefault(
                    key, np.full((self._n,), np.nan, np.float32))
                col[pos] = np.nan if value is None else _as_float(value)
            else:
                vocab, lookup, codes = self._cat.get(
                    key, ([""], {"": 0}, np.zeros((self._n,), np.int32))
                )
                v = "" if value is None else str(value)
                if v not in lookup:
                    lookup[v] = len(vocab)
                    vocab.append(v)
                codes[pos] = lookup[v]
                self._cat[key] = (vocab, lookup, codes)

    def row(self, i: int) -> dict[str, Any]:
        return self._docs[i]

    def rows(self, idx) -> list[dict[str, Any]]:
        return [self._docs[i] for i in idx]

    def column_names(self):
        return sorted(
            set(self._cat) | set(self._bool) | set(self._num) | set(self._set)
        )

    # ------------------------------------------------------------ filters
    def eq_mask(self, key: str, value) -> np.ndarray:
        if key in self._bool:
            return self._bool[key] == bool(value)
        if key in self._num and isinstance(value, str):
            f = _as_float(value)  # '2020' queries a numeric column
            if not np.isnan(f):
                return self._num[key] == f
        if key in self._num and isinstance(value, (int, float)) \
                and key not in self._cat:
            return self._num[key] == float(value)
        if key in self._cat:
            vocab, lookup, codes = self._cat[key]
            code = lookup.get("" if value is None else str(value))
            if code is None:
                return np.zeros((self._n,), bool)
            return codes == code
        return np.zeros((self._n,), bool)

    def contains_mask(self, key: str, value) -> np.ndarray:
        if key not in self._set:
            return self.eq_mask(key, value)
        vocab, lookup, bits = self._set[key]
        bit = lookup.get(str(value))
        if bit is None:
            return np.zeros((self._n,), bool)
        return (bits & (1 << bit)) != 0

    # --------------------------------------------------------- serialize
    def to_dict(self) -> dict:
        return {
            "docs": self._docs,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MetadataStore":
        store = cls()
        store.append(d["docs"])
        return store

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, ensure_ascii=False)

    @classmethod
    def load(cls, path) -> "MetadataStore":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def compile_filter(store: MetadataStore, where: Mapping | None) -> np.ndarray | None:
    """ChromaDB-style filter tree → boolean mask [N] (None = no filter).

    Supported: {field: value}, {field: {"$eq"/"$ne"/"$in"/"$nin"/"$gt"/
    "$gte"/"$lt"/"$lte"/"$contains": v}}, {"$and": [...]}, {"$or": [...]}.
    Same operator surface the reference relies on (`pipeline.py:35-71`
    builds $or over enterprise tags; nature filters use $in).
    """
    if not where:
        return None
    n = len(store)

    def rec(node) -> np.ndarray:
        if "$and" in node:
            m = np.ones((n,), bool)
            for sub in node["$and"]:
                m &= rec(sub)
            return m
        if "$or" in node:
            m = np.zeros((n,), bool)
            for sub in node["$or"]:
                m |= rec(sub)
            return m
        m = np.ones((n,), bool)
        for key, cond in node.items():
            if not isinstance(cond, Mapping):
                m &= store.eq_mask(key, cond)
                continue
            for op, val in cond.items():
                if op == "$eq":
                    m &= store.eq_mask(key, val)
                elif op == "$ne":
                    m &= ~store.eq_mask(key, val)
                elif op == "$in":
                    sub = np.zeros((n,), bool)
                    for v in val:
                        sub |= store.eq_mask(key, v)
                    m &= sub
                elif op == "$nin":
                    sub = np.zeros((n,), bool)
                    for v in val:
                        sub |= store.eq_mask(key, v)
                    m &= ~sub
                elif op == "$contains":
                    m &= store.contains_mask(key, val)
                elif op in ("$gt", "$gte", "$lt", "$lte"):
                    col = store._num.get(key)
                    if col is None:
                        m &= False
                    else:
                        cmpf = {
                            "$gt": np.greater, "$gte": np.greater_equal,
                            "$lt": np.less, "$lte": np.less_equal,
                        }[op]
                        with np.errstate(invalid="ignore"):
                            m &= cmpf(col, float(val))
                else:
                    raise ValueError(f"unsupported operator {op}")
        return m

    return rec(dict(where))
