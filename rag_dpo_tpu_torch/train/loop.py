"""Training loop: batches → steps → checkpoints → metrics.

Port of `rag_dpo_tpu/train/loop.py`: deterministic batching over (query,
passage) pair datasets (the numpy epoch order and grouping are the
reference's, so both packages draw the same batches), periodic
checkpointing, resume from the latest step, and JSONL metric logging.
`train_retriever` takes a mesh, as the reference does, or a torch device.
On a mesh every rank draws the same global batch and the sharded step
keeps its rows; the metrics lines are written by the first rank only.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import AXIS_DATA, axis_size, mesh_device
from ..tokenize import HashedTokenizer, Tokenizer
from .checkpoint import TrainCheckpointer
from .contrastive import (
    TrainConfig,
    create_train_state,
    make_sharded_train_step,
    make_train_step,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class LoopConfig:
    batch_size: int = 32
    max_steps: int = 1000
    seq_len: int = 64
    checkpoint_every: int = 100
    log_every: int = 10
    shuffle_seed: int = 0


class PairBatcher:
    """Deterministic epoch shuffling over (query, passage) text pairs.

    `groups` (optional, parallel to `pairs`) lays out each group's pairs
    contiguously in the epoch order, so pairs sharing a group key land in
    the same batch (hard in-batch negatives); `negatives` (parallel to
    `pairs`, entries may be None) adds one mined hard-negative passage per
    pair. Token ids are int64 tensors, lengths int32."""

    def __init__(self, pairs: Sequence[tuple[str, str]],
                 tokenizer: Tokenizer, batch_size: int, seq_len: int,
                 seed: int = 0, groups: Sequence | None = None,
                 negatives: Sequence | None = None):
        assert len(pairs) >= batch_size, "dataset smaller than batch"
        self.pairs = list(pairs)
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed
        self.groups = list(groups) if groups is not None else None
        if self.groups is not None:
            assert len(self.groups) == len(self.pairs), \
                "groups must parallel pairs"
        # per-pair mined hard-negative passage text (None where absent)
        self.negatives = (list(negatives) if negatives is not None
                          else None)
        if self.negatives is not None:
            assert len(self.negatives) == len(self.pairs), \
                "negatives must parallel pairs"

    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.pairs)
        rng = np.random.default_rng(self.seed + epoch)
        if self.groups is None:
            return rng.permutation(n)
        by_group: dict = {}
        for i, g in enumerate(self.groups):
            by_group.setdefault(g, []).append(i)
        keys = list(by_group)
        order = []
        for k in rng.permutation(len(keys)):
            members = by_group[keys[k]]
            order.extend(np.asarray(members)[
                rng.permutation(len(members))])
        return np.asarray(order)

    def _encode(self, texts) -> tuple:
        enc = self.tokenizer.encode_batch(texts, self.seq_len)
        return (torch.from_numpy(enc.input_ids.astype(np.int64)),
                torch.from_numpy(enc.lengths.astype(np.int32)))

    def batch_at(self, step: int) -> dict:
        n = len(self.pairs)
        per_epoch = n // self.batch_size
        epoch, slot = divmod(step, per_epoch)
        order = self._epoch_order(epoch)
        idx = order[slot * self.batch_size:(slot + 1) * self.batch_size]
        batch = {}
        batch["query_ids"], batch["query_lengths"] = self._encode(
            [self.pairs[i][0] for i in idx])
        batch["passage_ids"], batch["passage_lengths"] = self._encode(
            [self.pairs[i][1] for i in idx])
        if self.negatives is not None:
            # rows without a mined negative encode a placeholder and
            # mask it via negative_valid (the loss -infs its column)
            ids, lengths = self._encode(
                [self.negatives[i] or "" for i in idx])
            batch["negative_ids"] = ids
            batch["negative_lengths"] = lengths.clamp_min(1)
            batch["negative_valid"] = torch.tensor(
                [self.negatives[i] is not None for i in idx])
        return batch


def _is_mesh(x) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(x, DeviceMesh)


def train_retriever(
    pairs: Sequence[tuple[str, str]],
    train_config: TrainConfig,
    mesh,
    ckpt_dir,
    loop_config: LoopConfig | None = None,
    tokenizer: Tokenizer | None = None,
    metrics_path=None,
    groups: Sequence | None = None,
    negatives: Sequence | None = None,
    params=None,
):
    """Run (or resume) contrastive fine-tuning. → final TrainState.

    `mesh`: a `DeviceMesh` (every rank calls this; `ckpt_dir` is one
    every rank sees; the batch size must split over `data`), or a torch
    device. `groups` and `negatives` as in `PairBatcher`. `params`: the
    Flax tree to start from (seeded random weights without one)."""
    loop = loop_config or LoopConfig()
    tokenizer = tokenizer or HashedTokenizer(
        vocab_size=train_config.model.encoder.vocab_size)
    batcher = PairBatcher(pairs, tokenizer, loop.batch_size,
                          loop.seq_len, loop.shuffle_seed,
                          groups=groups, negatives=negatives)

    first = True
    if _is_mesh(mesh):
        n_data = axis_size(mesh, AXIS_DATA)
        if loop.batch_size % n_data:
            raise ValueError(f"batch_size {loop.batch_size} does not split "
                             f"over data={n_data}")
        state = create_train_state(train_config, device=mesh_device(mesh),
                                   params=params)
        step_fn, state = make_sharded_train_step(train_config, mesh, state)
        first = dist.get_rank() == 0
    else:
        state = create_train_state(train_config, device=mesh, params=params)
        step_fn = make_train_step(train_config, state)

    ckpt = TrainCheckpointer(ckpt_dir)
    latest = ckpt.latest_step()
    if latest is not None:
        state = ckpt.restore(state)
        log.info("resumed from step %d", latest)
    start = state.step

    metrics_file = None
    if metrics_path and first:
        pathlib.Path(metrics_path).parent.mkdir(parents=True,
                                                exist_ok=True)
        metrics_file = open(metrics_path, "a", encoding="utf-8")
    try:
        for step in range(start, loop.max_steps):
            batch = batcher.batch_at(step)
            state, metrics = step_fn(state, batch)
            if (step + 1) % loop.log_every == 0 or step == start:
                entry = {
                    "step": step + 1,
                    "loss": round(float(metrics["loss"]), 5),
                    "accuracy": round(float(metrics["accuracy"]), 4),
                    "ts": time.time(),
                }
                log.info("train %s", entry)
                if metrics_file:
                    metrics_file.write(json.dumps(entry) + "\n")
                    metrics_file.flush()
            if (step + 1) % loop.checkpoint_every == 0:
                ckpt.save(state)
        if ckpt.latest_step() != state.step:
            ckpt.save(state, force=True)
    finally:
        if metrics_file:
            metrics_file.close()
        ckpt.close()
    return state
