"""Per-query analytics + user feedback (JSONL) with derived stats.

Role parity with `src/utils/query_logger.py`: `log_query` records timings /
source counts / answer hash (:43-81), `log_feedback` ±1 ratings (:83-110),
`get_stats` derives error rate, citation rate, zero-citation queries and
satisfaction over a time window (:114-192), with 10 MB rotation (:214-245).
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import threading
import time
from typing import Any


class QueryLogger:
    def __init__(self, queries_path, feedback_path=None,
                 rotate_mb: int = 10):
        self.queries_path = pathlib.Path(queries_path)
        self.feedback_path = pathlib.Path(
            feedback_path
            or self.queries_path.with_name("feedback.jsonl")
        )
        self.rotate_bytes = rotate_mb * 1024 * 1024
        self.queries_path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()  # server handlers log concurrently

    # -------------------------------------------------------------- write
    def _append(self, path: pathlib.Path, entry: dict):
        with self._lock:
            if path.exists() and path.stat().st_size > self.rotate_bytes:
                rotated = path.with_suffix(path.suffix + ".1")
                if rotated.exists():
                    rotated.unlink()
                path.rename(rotated)
            with open(path, "a", encoding="utf-8") as f:
                f.write(json.dumps(entry, ensure_ascii=False) + "\n")

    def log_query(self, response, query_id: str | None = None,
                  pipeline: str = "native") -> str:
        qid = query_id or hashlib.md5(
            f"{response.question}{time.time()}".encode()
        ).hexdigest()[:12]
        self._append(self.queries_path, {
            "ts": time.time(),
            "query_id": qid,
            "pipeline": pipeline,
            "question": response.question,
            "intent": response.intent,
            "model": response.model,
            "retrieval_time": round(response.retrieval_time, 3),
            "rerank_time": round(response.rerank_time, 3),
            "generation_time": round(response.generation_time, 3),
            "total_time": round(response.total_time, 3),
            "n_candidates": response.n_candidates,
            "n_sources": len(response.sources),
            "n_cited": len(response.sources),
            "grounded": response.grounded,
            "retried": response.retried,
            "error": response.error,
            "answer_sha": hashlib.sha256(
                response.answer.encode()
            ).hexdigest()[:16],
            "answer_chars": len(response.answer),
        })
        return qid

    def log_feedback(self, query_id: str, rating: int,
                     comment: str = ""):
        self._append(self.feedback_path, {
            "ts": time.time(),
            "query_id": query_id,
            "rating": 1 if rating > 0 else -1,
            "comment": comment[:500],
        })

    # --------------------------------------------------------------- read
    def _read(self, path: pathlib.Path, since: float) -> list[dict]:
        out = []
        for p in (path.with_suffix(path.suffix + ".1"), path):
            if not p.exists():
                continue
            with open(p, encoding="utf-8") as f:
                for line in f:
                    try:
                        entry = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if entry.get("ts", 0) >= since:
                        out.append(entry)
        return out

    def recent_queries(self, window_s: float = 86_400) -> list[dict]:
        return self._read(self.queries_path, time.time() - window_s)

    def recent_feedback(self, window_s: float = 86_400) -> list[dict]:
        return self._read(self.feedback_path, time.time() - window_s)

    def get_stats(self, window_s: float = 86_400) -> dict[str, Any]:
        queries = self.recent_queries(window_s)
        feedback = self.recent_feedback(window_s)
        n = len(queries)
        if n == 0:
            return {"n_queries": 0}
        errors = [q for q in queries if q.get("error")]
        zero_cited = [q for q in queries if q.get("n_cited", 0) == 0
                      and not q.get("error")]
        pos = sum(1 for f in feedback if f.get("rating", 0) > 0)
        stats = {
            "n_queries": n,
            "error_rate": len(errors) / n,
            "avg_total_time": sum(q.get("total_time", 0)
                                  for q in queries) / n,
            "avg_generation_time": sum(q.get("generation_time", 0)
                                       for q in queries) / n,
            "citation_rate": 1.0 - len(zero_cited) / n,
            "zero_citation_rate": len(zero_cited) / n,
            "zero_citation_queries": [q["question"] for q in
                                      zero_cited][:20],
            "n_feedback": len(feedback),
            "satisfaction": pos / len(feedback) if feedback else None,
            "retry_rate": sum(1 for q in queries
                              if q.get("retried")) / n,
        }
        return stats
