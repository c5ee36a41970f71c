"""Embedding provider: batched BGE-M3 encode on one torch device.

Port of `rag_dpo_tpu/providers/embedding.py` with the same batch buckets
(1, 8, 64), the same sequence buckets (`tokenize.base.bucket_length`), and
the same `embed` / `embed_queries` outputs. The TPU-only tiny-fetch sync is
gone: the host copy of the outputs is the synchronisation. With
`enable_query_batching`, concurrent `embed_queries` calls coalesce into
one encoder forward on the batcher's thread (`serving.batcher`), padded to
the same batch buckets as the JAX package's (1, 8, 64, then powers of
two). `load_converted` takes an HF state dict (numpy arrays, as
`models/convert_weights.py::load_state_dict` reads a snapshot).

With a mesh (`Embedder(..., mesh=mesh)`) the encode is data-parallel, as
the JAX provider's: the batch bucket rounds up to the mesh's data axis,
each rank encodes its contiguous block of the padded batch on its device,
and one all-gather over the data group puts every rank's outputs back in
order. Every rank of the data axis calls the same encodes.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models import BgeM3Config, BgeM3Model
from ..models.bge_m3 import M3Output, build_bge_m3
from ..ops import default_device
from ..parallel import mesh as pmesh
from ..tokenize import HashedTokenizer, Tokenizer
from ..tokenize.base import bucket_length


@dataclasses.dataclass
class EmbedderConfig:
    model: BgeM3Config = dataclasses.field(default_factory=BgeM3Config.tiny)
    batch_size: int = 64
    max_seq_len: int = 8192
    query_max_len: int = 512
    batch_buckets: tuple = (1, 8, 64)


class Embedder:
    """Host-facing encode API over the torch BGE-M3 model.

    `params`: a Flax parameter tree as numpy (e.g. `load_params_npz`);
    None builds seeded random weights from `rng_seed` on `device`."""

    def __init__(
        self,
        config: EmbedderConfig | None = None,
        params=None,
        tokenizer: Tokenizer | None = None,
        rng_seed: int = 0,
        device=None,
        mesh=None,
    ):
        self.config = config or EmbedderConfig()
        self.mesh = mesh
        if mesh is not None and device is None:
            device = pmesh.mesh_device(mesh)
        self.device = default_device(device)
        # no HF tokenizer lookup: that needs transformers (ROADMAP C-7)
        self.tokenizer = tokenizer or HashedTokenizer(
            vocab_size=self.config.model.encoder.vocab_size
        )
        self._params = params
        self._rng_seed = rng_seed
        self.model: BgeM3Model | None = None
        self._query_batcher = None   # see enable_query_batching
        # bound in-flight encoder forwards under concurrent callers, as
        # the JAX provider does: each forward holds its activations. The
        # coalesced path does not take a slot while it waits on the
        # batcher: its one forward at a time runs on the batcher's thread
        self._dispatch_slots = threading.Semaphore(2)

    @property
    def dim(self) -> int:
        return self.config.model.encoder.hidden_size

    # ------------------------------------------------------------ weights
    def load(self) -> BgeM3Model:
        """Lazy model build: the given Flax params, else seeded random."""
        if self.model is None:
            self.model = build_bge_m3(self.config.model, self._params,
                                      self._rng_seed, self.device).eval()
        return self.model

    def load_converted(self, state_dict):
        """HF BGE-M3 state dict (backbone, plus the `sparse_linear.*` /
        `colbert_linear.*` heads) → this embedder's model on its device,
        converted as the JAX provider converts it; the model built before
        is dropped, and no host copy of the tree is kept."""
        from ..models.convert import convert_bge_m3_state_dict

        self.model = self._params = None
        self.model = build_bge_m3(
            self.config.model, convert_bge_m3_state_dict(state_dict),
            device=self.device).eval()

    def unload(self):
        """Drop the weights; the next `load` builds seeded random ones, as
        the JAX provider's `unload` drops its parameters."""
        self.model = None
        self._params = None

    # ------------------------------------------------------------- encode
    def _batch_bucket(self, b: int) -> int:
        bucket = next((x for x in self.config.batch_buckets if b <= x), b)
        if self.mesh is not None:
            bucket = pmesh.pad_to_multiple(
                bucket, pmesh.axis_size(self.mesh, pmesh.AXIS_DATA))
        return bucket

    def _encode_padded(self, texts: Sequence[str], max_len: int):
        model = self.load()
        enc = self.tokenizer.encode_batch(texts, max_len)
        seq = bucket_length(int(enc.lengths.max()) if len(texts) else 8)
        seq = min(seq, max_len)
        ids = enc.input_ids[:, :seq]
        b = len(texts)
        b_bucket = self._batch_bucket(b)
        lengths = enc.lengths
        if b_bucket != b:
            ids = np.concatenate(
                [ids, np.full((b_bucket - b, seq),
                              self.tokenizer.pad_id, np.int32)]
            )
            lengths = np.concatenate(
                [lengths, np.ones((b_bucket - b,), np.int32)]
            )
        with self._dispatch_slots:
            out = self._forward(model, ids, lengths)
        return out, b, enc

    def _forward(self, model, ids: np.ndarray, lengths: np.ndarray):
        """One encoder forward on `self.device`, named on every tensor:
        the batcher's thread has a current device of its own."""
        if self.mesh is not None:
            return self._forward_dp(model, ids, lengths)
        ids_t = torch.from_numpy(np.ascontiguousarray(ids, np.int64))
        len_t = torch.from_numpy(np.ascontiguousarray(lengths, np.int32))
        with torch.inference_mode():
            return model(ids_t.to(self.device), len_t.to(self.device))

    def _forward_dp(self, model, ids: np.ndarray, lengths: np.ndarray):
        """This rank's contiguous block of the batch through the model,
        then every rank's outputs gathered back in batch order."""
        data = pmesh.AXIS_DATA
        lo, hi = pmesh.local_row_range(ids.shape[0], self.mesh, data)
        ids_t = torch.from_numpy(np.ascontiguousarray(ids[lo:hi], np.int64))
        len_t = torch.from_numpy(
            np.ascontiguousarray(lengths[lo:hi], np.int32))
        group = self.mesh.get_group(data)
        n = pmesh.axis_size(self.mesh, data)

        def gather(x):
            if x is None:
                return None
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x.contiguous(), group=group)
            return torch.cat(parts)

        with torch.inference_mode():
            out = model(ids_t.to(self.device), len_t.to(self.device))
            return M3Output(dense=gather(out.dense),
                            sparse=gather(out.sparse),
                            colbert=gather(out.colbert))

    def embed(self, texts: Sequence[str], *, return_sparse: bool = False,
              return_colbert: bool = False):
        """Corpus encode → dict with 'dense' [B, H] f32 (+ optional heads).

        Sparse output is aggregated per token id: list of {term_id: weight}
        (max over repeated tokens, BGE-M3 convention); colbert is a list of
        [L_i, Dc] arrays cut at true length.
        """
        cfg = self.config
        out_dense, out_sparse, out_colbert = [], [], []
        for i in range(0, len(texts), cfg.batch_size):
            batch = list(texts[i : i + cfg.batch_size])
            out, b, enc = self._encode_padded(batch, cfg.max_seq_len)
            out_dense.append(out.dense[:b].float().cpu().numpy())
            if return_sparse and out.sparse is not None:
                sp = out.sparse[:b].float().cpu().numpy()
                for row in range(b):
                    L = int(enc.lengths[row])
                    weights: dict[int, float] = {}
                    for t, w in zip(enc.input_ids[row, :L], sp[row, :L]):
                        t = int(t)
                        if w <= 0 or t in (
                            self.tokenizer.cls_id, self.tokenizer.sep_id,
                            self.tokenizer.pad_id,
                        ):
                            continue
                        weights[t] = max(weights.get(t, 0.0), float(w))
                    out_sparse.append(weights)
            if return_colbert and out.colbert is not None:
                cb = out.colbert[:b].float().cpu().numpy()
                for row in range(b):
                    out_colbert.append(cb[row, : int(enc.lengths[row])])
        result = {"dense": np.concatenate(out_dense) if out_dense
                  else np.zeros((0, self.dim), np.float32)}
        if return_sparse:
            result["sparse"] = out_sparse
        if return_colbert:
            result["colbert"] = out_colbert
        return result

    def embed_query(self, text: str) -> np.ndarray:
        return self.embed_queries([text])[0]

    def embed_queries(self, texts: Sequence[str]) -> np.ndarray:
        """Query encode (shorter bucket) → [B, H] f32 L2-normalized.
        With `enable_query_batching`, concurrent callers coalesce into
        one encoder forward (rows are independent under the per-row key
        mask; the coalesced GEMMs' shapes differ, so a vector may differ
        from the direct one in its last bits)."""
        cfg = self.config
        texts = list(texts)
        if self._query_batcher is not None and texts:
            enc = self.tokenizer.encode_batch(texts, cfg.query_max_len)
            rows = np.concatenate(
                [enc.input_ids,
                 np.asarray(enc.lengths, np.int32)[:, None]],
                axis=1).astype(np.int32)
            (dense,) = self._query_batcher(rows)
            return dense
        out, b, _ = self._encode_padded(texts, cfg.query_max_len)
        return out.dense[:b].float().cpu().numpy()

    def enable_query_batching(self, max_batch: int = 64,
                              max_wait_ms: float = 3.0) -> None:
        """Coalesce concurrent embed_queries calls into one encoder
        forward (`serving.batcher.MicroBatcher`): under concurrent serving
        each query encodes its few expansion variants in its own small
        forward, each a full sweep of the encoder's weights. Idempotent."""
        if self._query_batcher is not None:
            return
        from ..serving.batcher import MicroBatcher

        self._query_batcher = MicroBatcher(
            self._query_batch_fn, max_batch=max_batch,
            max_wait_ms=max_wait_ms)

    def _query_batch_fn(self, stacked: np.ndarray, key):
        """MicroBatcher fn: rows are [query_max_len ids | true length]
        int32. The sequence bucket comes from the coalesced batch's
        longest row; the batch pads as the JAX provider's does: to the
        batch buckets up to the largest, past it to a power of two. Pad
        rows have length 1 and are cut off."""
        cfg = self.config
        model = self.load()
        ids_full, lengths = stacked[:, :-1], stacked[:, -1]
        b = stacked.shape[0]
        seq = min(bucket_length(int(lengths.max())), cfg.query_max_len)
        ids = ids_full[:, :seq]
        b_bucket = self._batch_bucket(
            b if b <= max(cfg.batch_buckets)
            else 1 << (b - 1).bit_length())
        if b_bucket != b:
            ids = np.concatenate(
                [ids, np.full((b_bucket - b, seq),
                              self.tokenizer.pad_id, np.int32)])
            lengths = np.concatenate(
                [lengths, np.ones((b_bucket - b,), np.int32)])
        out = self._forward(model, ids, lengths)
        return (out.dense[:b].float().cpu().numpy(),)
