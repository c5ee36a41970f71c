"""Structured JSONL application logging.

Role parity with `src/utils/structured_logger.py`: a JSON formatter with a
whitelist of extra fields (:27-50), a size-rotating JSONL file handler
(:53-82, 20 MB keep-1), console + file setup that silences noisy
third-party loggers (:85-134). Independent implementation on stdlib
logging.
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import pathlib
import time

EXTRA_FIELDS = (
    "query_id", "phase", "duration_ms", "n_results", "chunk_id",
    "doc_key", "model", "intent", "error_type", "device", "step",
)

_NOISY_LOGGERS = ("urllib3", "filelock", "fsspec", "jax._src.dispatch",
                  "jax._src.compiler", "absl")


class JSONFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S",
                                time.localtime(record.created)),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        for field in EXTRA_FIELDS:
            value = getattr(record, field, None)
            if value is not None:
                entry[field] = value
        if record.exc_info:
            entry["exception"] = self.formatException(record.exc_info)
        return json.dumps(entry, ensure_ascii=False)


def setup_structured_logging(
    log_file: str | pathlib.Path | None = None,
    level: str = "INFO",
    rotate_mb: int = 20,
    console: bool = True,
) -> logging.Logger:
    root = logging.getLogger()
    # idempotent under re-runs (Streamlit-style reruns re-call setup)
    for h in list(root.handlers):
        root.removeHandler(h)
    root.setLevel(level.upper())

    if console:
        ch = logging.StreamHandler()
        ch.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"
        ))
        root.addHandler(ch)
    if log_file is not None:
        path = pathlib.Path(log_file)
        path.parent.mkdir(parents=True, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            path, maxBytes=rotate_mb * 1024 * 1024, backupCount=1,
            encoding="utf-8",
        )
        fh.setFormatter(JSONFormatter())
        root.addHandler(fh)

    for name in _NOISY_LOGGERS:
        logging.getLogger(name).setLevel(logging.WARNING)
    return root
