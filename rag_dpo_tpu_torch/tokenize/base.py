"""Tokenizer interface: host-side text → fixed-shape device batches.

Tokenization stays on host (SURVEY.md §2.4: HF's Rust tokenizers are a host
dependency, not a device kernel). The contract every tokenizer implements
produces *static-shape* padded batches — a hard requirement for XLA: jitted
encode programs are compiled per (batch, seq_len) bucket, never per input.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence

import numpy as np


@dataclasses.dataclass
class Encoded:
    input_ids: np.ndarray  # [B, S] int32, padded with pad_id
    lengths: np.ndarray    # [B] int32 true lengths (incl. special tokens)


class Tokenizer(Protocol):
    pad_id: int
    cls_id: int
    sep_id: int
    vocab_size: int

    def encode_batch(self, texts: Sequence[str], max_len: int) -> Encoded: ...

    def encode_pairs(
        self, pairs: Sequence[tuple[str, str]], max_len: int
    ) -> Encoded: ...


def pad_batch(seqs: list[list[int]], max_len: int, pad_id: int) -> Encoded:
    b = len(seqs)
    out = np.full((b, max_len), pad_id, dtype=np.int32)
    lengths = np.zeros((b,), dtype=np.int32)
    for i, seq in enumerate(seqs):
        seq = seq[:max_len]
        out[i, : len(seq)] = seq
        lengths[i] = len(seq)
    return Encoded(input_ids=out, lengths=lengths)


def bucket_length(n: int, buckets: Sequence[int] = (32, 64, 128, 256, 512,
                                                    1024, 2048, 4096, 8192)):
    """Smallest bucket ≥ n (compile-cache friendly padding)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
