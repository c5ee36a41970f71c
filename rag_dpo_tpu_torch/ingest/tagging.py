"""Topic tagging of every chunk with checkpointed resume.

Role parity with `tag_all_chunks.py`: every chunk gets 1–3 tags from the
25-topic controlled vocabulary (`rag.topics`) via an LLM call, written
back into index metadata; idempotent with a checkpoint file every
`checkpoint_every` chunks (:51-63) so multi-hour tagging runs survive
interruption.
"""

from __future__ import annotations

import json
import pathlib

from ..providers.base import BaseLLMProvider
from ..rag.topics import RGPD_TOPICS, parse_topic_tags

TAG_PROMPT = """Attribue 1 à 3 thèmes à ce passage, choisis UNIQUEMENT
dans cette liste :
{topics}

Réponds par les thèmes séparés par des virgules, rien d'autre.

Passage :
{excerpt}

Thèmes :"""


class ChunkTagger:
    def __init__(self, llm: BaseLLMProvider,
                 checkpoint_path=None, checkpoint_every: int = 100):
        self.llm = llm
        self.checkpoint_path = (
            pathlib.Path(checkpoint_path) if checkpoint_path else None
        )
        self.checkpoint_every = checkpoint_every

    def _load_checkpoint(self) -> dict[str, list[str]]:
        if self.checkpoint_path and self.checkpoint_path.exists():
            return json.loads(self.checkpoint_path.read_text())
        return {}

    def _save_checkpoint(self, done: dict):
        if self.checkpoint_path:
            self.checkpoint_path.parent.mkdir(parents=True, exist_ok=True)
            self.checkpoint_path.write_text(
                json.dumps(done, ensure_ascii=False)
            )

    def tag_one(self, text: str) -> list[str]:
        from ..providers.base import background_priority_kwargs

        resp = self.llm.generate(
            TAG_PROMPT.format(topics="\n".join(f"- {t}" for t in
                                               RGPD_TOPICS),
                              excerpt=text[:2000]),
            temperature=0.0,
            **background_priority_kwargs(self.llm),
        )
        if not resp.ok:
            return []
        return parse_topic_tags(resp.text)

    def tag_index(self, index, texts: dict[str, str]) -> int:
        """Tag every live chunk lacking `rgpd_topics`; updates index
        metadata in place. Returns number tagged this run."""
        done = self._load_checkpoint()
        n_tagged = 0
        for i, chunk_id in enumerate(index.ids):
            if not index._alive[i]:
                continue
            meta = index.meta._docs[i]
            if meta.get("rgpd_topics"):
                continue
            tags = done.get(chunk_id)
            if tags is None:
                tags = self.tag_one(
                    texts.get(chunk_id, meta.get("text", ""))
                )
                done[chunk_id] = tags
                n_tagged += 1
                if n_tagged % self.checkpoint_every == 0:
                    self._save_checkpoint(done)
            # go through MetadataStore.update so the COLUMNAR filter
            # arrays learn the new tags too — writing meta["rgpd_topics"]
            # directly would leave where-filters evaluating stale columns
            # (same stale-column class as the round-1 upsert finding)
            updated = dict(meta)
            updated["rgpd_topics"] = tags
            index.meta.update(i, updated)
        self._save_checkpoint(done)
        return n_tagged
