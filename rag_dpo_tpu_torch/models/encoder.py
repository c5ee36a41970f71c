"""Transformer encoder backbone (XLM-RoBERTa architecture) in PyTorch.

Port of `rag_dpo_tpu/models/encoder.py`. Module names follow the Flax scope
names (`layer_{i}.attention.query`, `attention_norm`, `intermediate`,
`mlp_output`, `output_norm`, …) so a Flax parameter tree maps onto the state
dict one to one (`models.convert.load_flax_params`).

Numerics kept from the reference: activations in `config.dtype` (f32 by
default, or bf16), parameters in f32 and cast to that dtype for each
product and lookup, as Flax's `nn.Dense(dtype=)` and `nn.Embed(dtype=)`
cast them; LayerNorm statistics in f32 with Flax's fast variance
(E[x²] − E[x]², floored at 0) and a cast back, exact-erf GELU, RoBERTa
positions counted from the pad id. Attention goes through the flash kernels
(`ops.flash_attention_bwd.flash_attention_fused`: the forward kernel, and
the backward kernels when a gradient is asked for) unless
`use_flash_attention` is off, where it takes the plain softmax reference,
as the JAX encoder does. `attention_impl="ring"` shards the sequence over
the `shard` axis of the mesh that an enclosing
`parallel.context_parallel(mesh)` scope names (`ops.ring_attention`). `remat` recomputes each layer in the backward pass
(`torch.utils.checkpoint`), as the JAX encoder's `nn.remat` does.

Tensor parallelism (`tp`, this rank's `models.sharding.TensorParallel`):
the layers hold their Megatron slices under JAX's rules — query, key,
value and intermediate 1/tp of their output features behind *f*
(`parallel.collectives.copy_to_model`), output and mlp_output 1/tp of
their input features, their partial products summed by *g*
(`reduce_from_model`) before the replicated bias is added once, as XLA
adds it after the reduction. Attention runs on this rank's
num_heads / tp heads; where tp does not divide num_heads, q, k and v are
all-gathered first and every rank attends over all heads, keeping its own
features of the context (equal results). Embeddings and LayerNorms stay
whole.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint
from torch import nn
from torch.nn import functional as F

from ..ops.flash_attention import attention_reference
from ..ops.flash_attention_bwd import flash_attention_fused
from ..parallel.collectives import (
    all_gather,
    copy_to_model,
    reduce_from_model,
)
from .sharding import split_size


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 250_002          # XLM-RoBERTa vocabulary
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 8194
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    dtype: torch.dtype = torch.float32
    use_flash_attention: bool = True
    # kept for config parity with the JAX package; the CUDA kernel picks
    # its own 64-row tiles
    flash_block_q: int = 512
    flash_block_k: int = 512
    # 'flash', 'reference', 'auto' (flash iff use_flash_attention), or
    # 'ring': context parallelism, the sequence sharded over the mesh
    # `shard` axis of an enclosing `parallel.context_parallel(mesh)` scope
    attention_impl: str = "auto"
    # recompute each layer in the backward pass: more FLOPs for less
    # activation memory (training only; a no-op without gradients)
    remat: bool = False

    @classmethod
    def tiny(cls, **kw) -> "EncoderConfig":
        """Small config for tests / synthetic corpora."""
        defaults = dict(
            vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=514,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def bge_m3(cls, **kw) -> "EncoderConfig":
        """XLM-RoBERTa-large — the BGE-M3 backbone (568M params)."""
        return cls(**kw)


def position_ids_from_inputs(input_ids, pad_token_id: int):
    """RoBERTa-style positions: pad stays at pad_id, others count from it."""
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


class LayerNorm(nn.Module):
    """Flax `nn.LayerNorm(dtype=f32)`: f32 statistics with the fast
    variance, y = (x − μ)·(rsqrt(σ² + ε)·weight) + bias."""

    def __init__(self, size: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))

    def forward(self, x):
        x = x.float()
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return (x - mu) * mul + self.bias.float()


class Dense(nn.Linear):
    """Flax `nn.Dense(dtype=)`: f32 parameters; the input, kernel and bias
    cast to `dtype`, the product rounded to it, then the bias added in it.
    In f32 this is `nn.Linear` itself. Outside a backward pass the cast
    kernel and bias stay resident and are made again only when the
    parameters change (their version counters move on a load or an
    optimizer step), which gives the bits of Flax's cast per call without
    its traffic."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, features)
        self.dtype = dtype
        self._cast = None

    def _cast_params(self):
        w, b = self.weight, self.bias
        if torch.is_grad_enabled() and w.requires_grad:
            return w.to(self.dtype), b.to(self.dtype)    # differentiable
        key = (w._version, b._version, w.data_ptr(), b.data_ptr())
        if self._cast is None or self._cast[0] != key:
            self._cast = (key, w.detach().to(self.dtype),
                          b.detach().to(self.dtype))
        return self._cast[1], self._cast[2]

    def forward(self, x):
        if self.dtype == self.weight.dtype:
            return super().forward(x.to(self.dtype))
        w, b = self._cast_params()
        return F.linear(x.to(self.dtype), w) + b

    def forward_row(self, x, tp):
        """A `_ROW` product under TP: this rank's input features times its
        rows of the kernel, summed over the model axis, then the bias
        once. Without TP, `forward`."""
        if tp is None:
            return self(x)
        if self.dtype == self.weight.dtype:
            w, b = self.weight, self.bias
        else:
            w, b = self._cast_params()
        return reduce_from_model(F.linear(x.to(self.dtype), w), tp) + b


def _tp_of(tp):
    return tp if tp is not None and tp.size > 1 else None


class SelfAttention(nn.Module):
    def __init__(self, config: EncoderConfig, tp=None):
        super().__init__()
        h, dt = config.hidden_size, config.dtype
        self.config = config
        self.tp = tp = _tp_of(tp)
        f = split_size(h, tp, "hidden_size")
        self.gather = tp is not None and config.num_heads % tp.size != 0
        self.heads = (config.num_heads // tp.size
                      if tp is not None and not self.gather
                      else config.num_heads)
        self.query = Dense(h, f, dt)
        self.key = Dense(h, f, dt)
        self.value = Dense(h, f, dt)
        self.output = Dense(f, h, dt)

    def forward(self, hidden, lengths):
        cfg, tp = self.config, self.tp
        b, s, h = hidden.shape
        nh = self.heads
        dh = h // cfg.num_heads

        def heads(x):
            return x.reshape(b, s, nh, dh).transpose(1, 2)

        x = copy_to_model(hidden, tp)
        q, k, v = (lin(x) for lin in (self.query, self.key, self.value))
        if self.gather:
            q, k, v = (all_gather(t, tp, dim=-1) for t in (q, k, v))
        q, k, v = heads(q), heads(k), heads(v)
        impl = cfg.attention_impl
        if impl == "auto":
            impl = "flash" if cfg.use_flash_attention else "reference"
        if impl == "ring":
            from ..ops.ring_attention import ring_attention_inline
            from ..parallel.mesh import active_cp_mesh

            mesh = active_cp_mesh()
            if mesh is None:
                raise RuntimeError(
                    "attention_impl='ring' needs an enclosing "
                    "`with parallel.context_parallel(mesh):` scope")
            ctx = ring_attention_inline(mesh, q, k, v, lengths)
        elif impl == "flash":
            ctx = flash_attention_fused(q, k, v, lengths)
        else:
            ctx = attention_reference(q, k, v, lengths)
        ctx = ctx.transpose(1, 2).reshape(b, s, nh * dh)
        if self.gather:
            per = h // tp.size
            ctx = ctx[..., tp.rank * per:(tp.rank + 1) * per]
        return self.output.forward_row(ctx, tp)


class EncoderLayer(nn.Module):
    def __init__(self, config: EncoderConfig, tp=None):
        super().__init__()
        self.config = config
        self.tp = tp = _tp_of(tp)
        eps = config.layer_norm_eps
        f = split_size(config.intermediate_size, tp, "intermediate_size")
        self.attention = SelfAttention(config, tp)
        self.attention_norm = LayerNorm(config.hidden_size, eps)
        self.intermediate = Dense(config.hidden_size, f, config.dtype)
        self.mlp_output = Dense(f, config.hidden_size, config.dtype)
        self.output_norm = LayerNorm(config.hidden_size, eps)

    def forward(self, hidden, lengths):
        dtype = self.config.dtype
        attn_out = self.attention(hidden, lengths)
        hidden = self.attention_norm(hidden + attn_out).to(dtype)
        mlp = nn.functional.gelu(
            self.intermediate(copy_to_model(hidden, self.tp)),
            approximate="none")
        mlp = self.mlp_output.forward_row(mlp, self.tp)
        return self.output_norm(hidden + mlp).to(dtype)


class TransformerEncoder(nn.Module):
    """Post-LN encoder; returns final hidden states [B, S, H]. `tp`: this
    rank's `TensorParallel` (its slices are allocated), or None."""

    def __init__(self, config: EncoderConfig, tp=None):
        super().__init__()
        if config.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"encoder dtype is f32 or bf16, got "
                             f"{config.dtype}")
        self.config = config
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h)
        self.embeddings_norm = LayerNorm(h, config.layer_norm_eps)
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(config, tp))

    def layers(self):
        return [getattr(self, f"layer_{i}")
                for i in range(self.config.num_layers)]

    def forward(self, input_ids, lengths=None):
        cfg = self.config
        if lengths is None:
            lengths = (input_ids != cfg.pad_token_id).sum(dim=1)
        lengths = lengths.to(torch.int32)
        pos_ids = position_ids_from_inputs(input_ids, cfg.pad_token_id)
        dt = cfg.dtype
        emb = (self.word_embeddings(input_ids).to(dt)
               + self.position_embeddings(pos_ids).to(dt)
               + self.token_type_embeddings(
                   torch.zeros_like(input_ids)).to(dt))
        hidden = self.embeddings_norm(emb).to(cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers():
            if remat:
                hidden = torch.utils.checkpoint.checkpoint(
                    layer, hidden, lengths, use_reentrant=False)
            else:
                hidden = layer(hidden, lengths)
        return hidden


def init_random_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init in place, on the module's device, as the JAX
    module's `model.init(jax.random.key(seed), ...)` makes it
    (`models.flax_init`): Dense kernels lecun_normal (a normal truncated
    at ±2σ), biases 0, Embed tables normal with std 1/sqrt(features),
    LayerNorm scales 1 and biases 0, every value drawn by Flax's threefry
    keys. `module` is the root of the Flax tree (a `BgeM3Model`,
    `CrossEncoderModel` or `TransformerEncoder`)."""
    from .flax_init import init_module_

    return init_module_(module, seed)
