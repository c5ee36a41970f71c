"""Cross-encoder reranker on one torch device.

Port of `rag_dpo_tpu/retrieval/reranker.py::CrossEncoderReranker` and
`default_reranker`, with the reference semantics kept: (query, heading +
passage) pairs scored in padded batches, the topic-tag boost (≤ +0.15),
the min_score=0.08 filter with a keep-≥3 fallback, and the fallback to the
incoming order on any error. That last rule would also hide a kernel
failure, so the smoke asserts every reranked chunk carries a
`rerank_score`. The MaxSim reranker and pair batching are later slices of
the port (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..models import CrossEncoderModel, EncoderConfig
from ..models.convert import load_flax_params
from ..models.encoder import init_random_
from ..ops import default_device
from ..tokenize import HashedTokenizer, Tokenizer
from ..tokenize.base import bucket_length
from .types import RetrievedChunk


@dataclasses.dataclass
class RerankerConfig:
    max_len: int = 512           # configurable; no hard architecture cap
    min_score: float = 0.08
    min_keep: int = 3
    batch_size: int = 64


class CrossEncoderReranker:
    def __init__(
        self,
        config: RerankerConfig | None = None,
        model_config: EncoderConfig | None = None,
        params=None,
        tokenizer: Tokenizer | None = None,
        topic_matcher=None,
        rng_seed: int = 1,
        device=None,
    ):
        """`params`: a Flax parameter tree as numpy; None builds seeded
        random weights from `rng_seed` on `device`."""
        self.config = config or RerankerConfig()
        self.model_config = model_config or EncoderConfig.tiny()
        self.device = default_device(device)
        self.tokenizer = tokenizer or HashedTokenizer(
            vocab_size=self.model_config.vocab_size
        )
        self._params = params
        self._rng_seed = rng_seed
        self.model: CrossEncoderModel | None = None
        self.topic_matcher = topic_matcher

    def load(self) -> CrossEncoderModel:
        """Lazy model build (reference `_load_model` at :74-108)."""
        if self.model is None:
            if self._params is not None:
                model = load_flax_params(CrossEncoderModel(self.model_config),
                                         self._params).to(self.device)
            else:
                with torch.device(self.device):  # no host-side init pass
                    model = CrossEncoderModel(self.model_config)
                gen = torch.Generator(device=self.device)
                gen.manual_seed(self._rng_seed)
                init_random_(model, gen)
            self.model = model.eval()
        return self.model

    def score_pairs(self, pairs: Sequence[tuple[str, str]]) -> np.ndarray:
        """Sigmoid relevance scores for (query, passage) pairs."""
        model = self.load()
        cfg = self.config
        out = []
        for i in range(0, len(pairs), cfg.batch_size):
            batch = list(pairs[i : i + cfg.batch_size])
            enc = self.tokenizer.encode_pairs(batch, cfg.max_len)
            seq = min(bucket_length(int(enc.lengths.max())), cfg.max_len)
            ids = enc.input_ids[:, :seq]
            b = len(batch)
            b_pad = max(8, 1 << (b - 1).bit_length())
            lengths = enc.lengths
            if b_pad != b:
                ids = np.concatenate([
                    ids,
                    np.full((b_pad - b, seq), self.tokenizer.pad_id, np.int32),
                ])
                lengths = np.concatenate(
                    [lengths, np.ones((b_pad - b,), np.int32)]
                )
            ids_t = torch.from_numpy(np.ascontiguousarray(ids, np.int64))
            len_t = torch.from_numpy(np.ascontiguousarray(lengths, np.int32))
            with torch.inference_mode():
                logits = model(ids_t.to(self.device), len_t.to(self.device))
                out.append(torch.sigmoid(logits)[:b].cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0,), np.float32)

    def rerank(
        self,
        question: str,
        chunks: Sequence[RetrievedChunk],
        top_k: int = 10,
        question_topics: Sequence[str] | None = None,
    ) -> list[RetrievedChunk]:
        if not chunks:
            return []
        cfg = self.config
        try:
            pairs = []
            for c in chunks:
                passage = f"{c.heading}\n{c.text}" if c.heading else c.text
                pairs.append((question, passage))
            scores = self.score_pairs(pairs)
            boosted = []
            for c, s in zip(chunks, scores):
                boost = 0.0
                if self.topic_matcher is not None and question_topics:
                    tags = c.metadata.get("rgpd_topics") or []
                    if isinstance(tags, str):
                        tags = [t.strip() for t in tags.split(",") if t.strip()]
                    boost = self.topic_matcher.topic_boost(
                        list(question_topics), tags
                    )
                boosted.append(float(s) + boost)
            order = np.argsort(-np.asarray(boosted), kind="stable")
            ranked = []
            for pos in order[:top_k]:
                c = chunks[pos]
                ranked.append(dataclasses.replace(
                    c, rerank_score=boosted[pos], score=boosted[pos]
                ))
            kept = [c for c in ranked if c.rerank_score >= cfg.min_score]
            if len(kept) < cfg.min_keep:  # keep-≥3 fallback
                kept = ranked[: max(cfg.min_keep, len(kept))]
            return kept
        except Exception:
            # degradation ladder: return incoming order untouched
            return list(chunks[:top_k])


def default_reranker(embedder, model_config=None,
                     rerank_batch: int = 0) -> "CrossEncoderReranker":
    """The default production reranker: cross-encoder + topic matcher,
    on the embedder's device. Pair batching (`rerank_batch` > 0) belongs
    to the serving slice of the port."""
    from ..rag.topics import TopicMatcher

    if rerank_batch > 0:
        raise NotImplementedError(
            "rerank pair batching is not ported yet (ROADMAP, port queue "
            "item 7: serving)")
    return CrossEncoderReranker(
        model_config=model_config,
        topic_matcher=TopicMatcher(embedder),
        device=getattr(embedder, "device", None))


class MaxSimReranker:
    """ColBERT late-interaction rerank: its MaxSim kernel (ROADMAP B6) is
    not ported yet, so building one raises."""

    def __init__(self, index, embedder):
        raise NotImplementedError(
            "MaxSimReranker is not ported yet (ROADMAP, port queue item 5)")
