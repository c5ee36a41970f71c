"""Rerankers on one torch device: cross-encoder and ColBERT MaxSim.

Port of `rag_dpo_tpu/retrieval/reranker.py`. `CrossEncoderReranker` and
`default_reranker` keep the reference semantics: (query, heading +
passage) pairs scored in padded batches, the topic-tag boost (≤ +0.15),
the min_score=0.08 filter with a keep-≥3 fallback, and the fallback to the
incoming order on any error. That last rule would also hide a kernel
failure, so the smoke asserts every reranked chunk carries a
`rerank_score`. `MaxSimReranker` scores the stored ColBERT rows with the
MaxSim kernel (`ops.maxsim`) and, as in the reference, has no fallback.
With `enable_pair_batching`, concurrent `score_pairs` calls coalesce into
shared cross-encoder forwards on the batcher's thread (`serving.batcher`),
padded to the direct path's power-of-two batches.
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
from ..ops.maxsim import maxsim
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
        self._pair_batcher = None   # see enable_pair_batching

    def load(self) -> CrossEncoderModel:
        """Lazy model build (reference `_load_model` at :74-108)."""
        if self.model is None:
            if self._params is not None:
                model = load_flax_params(CrossEncoderModel(self.model_config),
                                         self._params).to(self.device)
            else:
                with torch.device(self.device):  # no host-side init pass
                    model = CrossEncoderModel(self.model_config)
                init_random_(model, self._rng_seed)
            self.model = model.eval()
        return self.model

    def load_converted(self, state_dict):
        """HF sequence-classification state dict (`roberta.*` +
        `classifier.*`) → this reranker's model on its device, converted
        as the JAX reranker converts it; the model built before is
        dropped, and no host copy of the tree is kept. A bare
        `classifier.weight` head builds the model without its dense
        layer."""
        from ..models.convert import convert_cross_encoder_state_dict

        tree = convert_cross_encoder_state_dict(state_dict)
        self.model = self._params = None
        model = CrossEncoderModel(self.model_config,
                                  with_head_dense="head_dense" in tree)
        self.model = load_flax_params(model, tree).to(self.device).eval()

    def score_pairs(self, pairs: Sequence[tuple[str, str]]) -> np.ndarray:
        """Sigmoid relevance scores for (query, passage) pairs. With
        `enable_pair_batching`, concurrent callers' pairs coalesce into
        shared cross-encoder forwards (rows are independent under the
        per-row key mask)."""
        cfg = self.config
        if self._pair_batcher is not None and len(pairs):
            enc = self.tokenizer.encode_pairs(list(pairs), cfg.max_len)
            rows = np.concatenate(
                [enc.input_ids,
                 np.asarray(enc.lengths, np.int32)[:, None]],
                axis=1).astype(np.int32)
            (scores,) = self._pair_batcher(rows)
            return scores
        out = []
        for i in range(0, len(pairs), cfg.batch_size):
            enc = self.tokenizer.encode_pairs(
                list(pairs[i : i + cfg.batch_size]), cfg.max_len)
            out.append(self._scores(enc.input_ids, enc.lengths))
        return np.concatenate(out) if out else np.zeros((0,), np.float32)

    def _scores(self, ids_full: np.ndarray, lengths: np.ndarray
                ) -> np.ndarray:
        """One padded forward: the sequence bucket of the longest row, the
        batch padded to a power of two (at least 8) with length-1 rows,
        which are cut off. Every tensor names `self.device`: the batcher's
        thread has a current device of its own."""
        model = self.load()
        cfg = self.config
        seq = min(bucket_length(int(lengths.max())), cfg.max_len)
        ids = ids_full[:, :seq]
        b = ids.shape[0]
        b_pad = max(8, 1 << (b - 1).bit_length())
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
            return torch.sigmoid(logits)[:b].cpu().numpy()

    def enable_pair_batching(self, max_batch: int | None = None,
                             max_wait_ms: float = 3.0) -> None:
        """Coalesce concurrent score_pairs calls into shared cross-encoder
        forwards (`serving.batcher.MicroBatcher`). `max_batch` defaults to
        `config.batch_size`, the direct path's largest batch. Idempotent."""
        if self._pair_batcher is not None:
            return
        from ..serving.batcher import MicroBatcher

        self._pair_batcher = MicroBatcher(
            self._pair_batch_fn,
            max_batch=(self.config.batch_size if max_batch is None
                       else max_batch),
            max_wait_ms=max_wait_ms)

    def _pair_batch_fn(self, stacked: np.ndarray, key):
        """MicroBatcher fn: rows are [max_len ids | true length] int32."""
        return (self._scores(stacked[:, :-1], stacked[:, -1]),)

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
    on the embedder's device. `rerank_batch` > 0 coalesces concurrent
    pair-scoring."""
    from ..rag.topics import TopicMatcher

    rr = CrossEncoderReranker(
        model_config=model_config,
        topic_matcher=TopicMatcher(embedder),
        device=getattr(embedder, "device", None))
    if rerank_batch > 0:
        rr.enable_pair_batching(max_batch=int(rerank_batch))
    return rr


class MaxSimReranker:
    """Late-interaction rerank over stored ColBERT vectors, on the
    index's device."""

    def __init__(self, index, embedder):
        self.index = index
        self.embedder = embedder

    def rerank(self, question: str, chunks: Sequence[RetrievedChunk],
               top_k: int = 10, question_topics=None
               ) -> list[RetrievedChunk]:
        if not chunks:
            return []
        out = self.embedder.embed([question], return_colbert=True)
        qv = out["colbert"][0]  # [Lq, Dc] f32
        rows = [c.row for c in chunks]
        dev = self.index.device
        # the stored f16 rows cross as f16; the kernel widens them exactly
        dv = torch.from_numpy(self.index.colbert_vectors(rows)).to(dev)
        d_mask = (dv != 0).any(dim=2)
        lq = qv.shape[0]
        scores = maxsim(
            torch.from_numpy(np.ascontiguousarray(qv[None], np.float32))
            .to(dev),
            torch.ones((1, lq), dtype=torch.bool, device=dev),
            dv, d_mask,
        )
        scores = scores.cpu().numpy()[0] / max(lq, 1)  # length-normalized
        order = np.argsort(-scores, kind="stable")[:top_k]
        return [
            dataclasses.replace(
                chunks[i], rerank_score=float(scores[i]),
                score=float(scores[i]),
            )
            for i in order
        ]
