"""BGE-M3-style multi-representation embedder in PyTorch.

Port of `rag_dpo_tpu/models/bge_m3.py`: one forward yields

* dense   — L2-normalized CLS hidden state               [B, H]
* sparse  — per-token lexical weight relu(w·h_t)          [B, S]
* colbert — per-token projected vectors, L2-normalized    [B, S, Dc]

`dense_only=True` runs the encoder and the dense head alone, as the JAX
training step's dense-only model does (`train/contrastive.py:141-148`):
the module keeps its sparse and ColBERT heads, so a checkpoint saves them.

Tensor parallelism: `build_bge_m3(config, params=shard_params(tree,
mesh))` builds the encoder from this rank's Megatron slices
(`models/encoder.py`); the embeddings, LayerNorms and the three heads stay
whole, as JAX's rules leave them. `full_flax_tree` gathers a rank's model
back into the whole Flax tree over the model axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..ops import default_device
from .convert import load_flax_params, state_dict_to_flax
from .encoder import Dense, EncoderConfig, TransformerEncoder, init_random_
from .sharding import ShardedParams, gather_state


@dataclasses.dataclass(frozen=True)
class BgeM3Config:
    encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    colbert_dim: int = 1024
    with_sparse: bool = True
    with_colbert: bool = True

    @classmethod
    def tiny(cls, **kw) -> "BgeM3Config":
        return cls(encoder=EncoderConfig.tiny(), colbert_dim=32, **kw)


@dataclasses.dataclass
class M3Output:
    dense: Any          # [B, H]  L2-normalized
    sparse: Any | None  # [B, S]  ≥0 token weights (0 at padding)
    colbert: Any | None  # [B, S, Dc] L2-normalized, zeroed at padding


def _l2norm(x, dim=-1, eps=1e-12):
    xf = x.float()
    n = torch.sqrt(torch.sum(xf * xf, dim=dim, keepdim=True))
    return (xf / n.clamp_min(eps)).to(x.dtype)


class BgeM3Model(nn.Module):
    """`tp`: this rank's `models.sharding.TensorParallel`, or None."""

    def __init__(self, config: BgeM3Config, tp=None):
        super().__init__()
        self.config = config
        self.tp = tp if tp is not None and tp.size > 1 else None
        h = config.encoder.hidden_size
        self.encoder = TransformerEncoder(config.encoder, self.tp)
        dt = config.encoder.dtype
        if config.with_sparse:
            self.sparse_head = Dense(h, 1, dt)
        if config.with_colbert:
            self.colbert_head = Dense(h, config.colbert_dim, dt)

    def forward(self, input_ids, lengths=None,
                dense_only: bool = False) -> M3Output:
        cfg = self.config
        if lengths is None:
            lengths = (input_ids != cfg.encoder.pad_token_id).sum(dim=1)
        hidden = self.encoder(input_ids, lengths)
        s = hidden.shape[1]
        valid = (torch.arange(s, device=hidden.device)[None, :]
                 < lengths.to(hidden.device)[:, None])  # [B, S]

        dense = _l2norm(hidden[:, 0, :])  # CLS
        sparse = None
        if cfg.with_sparse and not dense_only:
            w = self.sparse_head(hidden)[..., 0].float().relu()
            sparse = torch.where(valid, w, 0.0)
        colbert = None
        if cfg.with_colbert and not dense_only:
            cv = _l2norm(self.colbert_head(hidden))
            colbert = torch.where(valid[:, :, None], cv, 0.0)
        return M3Output(dense=dense, sparse=sparse, colbert=colbert)


def build_bge_m3(config: BgeM3Config, params=None, rng_seed: int = 0,
                 device=None) -> BgeM3Model:
    """A `BgeM3Model` on `device` (the card unless given; without a card
    `device="cpu"` must be asked for): the given Flax tree (numpy leaves,
    e.g. `load_params_npz`), else seeded random weights made on the
    device. A `ShardedParams` tree builds the TP model of its rank, on the
    rank's device unless `device` is given."""
    if isinstance(params, ShardedParams):
        from ..parallel.mesh import mesh_device

        model = BgeM3Model(config, params.tp)
        device = device if device is not None else mesh_device(params.mesh)
        return load_flax_params(model, params).to(device)
    device = default_device(device)
    if params is not None:
        return load_flax_params(BgeM3Model(config), params).to(device)
    with device:  # no host-side init pass
        model = BgeM3Model(config)
    gen = torch.Generator(device=device)
    gen.manual_seed(rng_seed)
    return init_random_(model, gen)


def full_flax_tree(model: BgeM3Model) -> dict:
    """The whole bare Flax tree (numpy f32 leaves) of a model, its TP
    slices gathered over the model axis: every rank of the model group
    calls this; an unsharded model needs no collective."""
    return state_dict_to_flax(model, gather_state(
        dict(model.named_parameters()), model.tp))
