"""Central, env-overridable path configuration.

Role parity with `src/utils/paths.py` (:24-52): one place defining the
data layout, every location overridable through environment variables so
Docker/CI can relocate state without code changes.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib


@dataclasses.dataclass(frozen=True)
class Paths:
    root: pathlib.Path
    data: pathlib.Path
    raw: pathlib.Path
    keep: pathlib.Path
    archive: pathlib.Path
    index_dir: pathlib.Path
    logs: pathlib.Path
    tasks: pathlib.Path
    configs: pathlib.Path
    eval_dir: pathlib.Path

    def ensure(self) -> "Paths":
        for p in (self.data, self.raw, self.keep, self.archive,
                  self.index_dir, self.logs, self.tasks):
            p.mkdir(parents=True, exist_ok=True)
        return self

    @property
    def processed_chunks(self) -> pathlib.Path:
        return self.data / "processed_chunks.jsonl"

    @property
    def document_summaries(self) -> pathlib.Path:
        return self.data / "document_summaries.json"

    @property
    def document_metadata(self) -> pathlib.Path:
        return self.data / "document_metadata.json"

    @property
    def keep_manifest(self) -> pathlib.Path:
        return self.data / "keep_manifest.json"

    @property
    def enterprise_tags(self) -> pathlib.Path:
        return self.configs / "enterprise_tags.json"

    @property
    def queries_log(self) -> pathlib.Path:
        return self.logs / "queries.jsonl"

    @property
    def feedback_log(self) -> pathlib.Path:
        return self.logs / "feedback.jsonl"

    @property
    def alerts_log(self) -> pathlib.Path:
        return self.logs / "alerts.jsonl"


def default_paths(root: str | os.PathLike | None = None) -> Paths:
    root_path = pathlib.Path(
        root or os.environ.get("RAGDPO_TPU_ROOT", ".")
    ).resolve()

    def env(name: str, default: pathlib.Path) -> pathlib.Path:
        v = os.environ.get(name)
        return pathlib.Path(v).resolve() if v else default

    data = env("RAGDPO_TPU_DATA", root_path / "data")
    return Paths(
        root=root_path,
        data=data,
        raw=env("RAGDPO_TPU_RAW", data / "raw"),
        keep=env("RAGDPO_TPU_KEEP", data / "keep"),
        archive=env("RAGDPO_TPU_ARCHIVE", data / "archive"),
        index_dir=env("RAGDPO_TPU_INDEX", data / "index"),
        logs=env("RAGDPO_TPU_LOGS", root_path / "logs"),
        tasks=env("RAGDPO_TPU_TASKS", root_path / "tasks"),
        configs=env("RAGDPO_TPU_CONFIGS", root_path / "configs"),
        eval_dir=env("RAGDPO_TPU_EVAL", root_path / "eval"),
    )
