"""Decoder LLM (Llama/Mistral architecture family) in PyTorch.

Port of `rag_dpo_tpu/models/decoder.py`: RMSNorm, rotary position
embeddings (rotate_half), grouped-query attention, a SwiGLU MLP, weight-only
int8 projections (`QuantDense`) and an int8 KV cache. Module names follow
the Flax scope names (`layer_{i}.attention.q_proj`, `input_norm`,
`post_attention_norm`, `gate_proj`, `embed_tokens`, `final_norm`, ...), so a
Flax parameter tree maps onto the state dict one to one
(`models.convert.load_flax_params`).

Numerics kept from the reference:

* activations in `config.dtype` (bf16 by default), parameters in
  `param_dtype`; RMSNorm and the rotary angles in f32;
* `QuantDense`: the activation in the compute dtype times the int8 kernel
  widened to it, the product in that dtype, then `* scale` cast to it; the
  int8 kernel stays int8 in memory (a bf16 copy lives only for the call);
* attention logits, softmax and the weighted sum in f32, masked keys set to
  −1e30; the tied head is Flax's `Embed.attend`, which computes in the
  module's dtype (`hidden` and the table cast to `config.dtype`);
* the int8 KV cache quantizes each fresh (position, head) row with
  `scale = amax / 127`, rounds half to even, and attends the cache
  dequantized to the activation dtype;
* a cache write lands where `lax.dynamic_update_slice` puts it: the window
  of S rows starts at `min(positions[:, 0], max_len - S)`, and `write_mask`
  zeroes the rows of padding tokens.

Tensor parallelism (`models/sharding.py`): a model built with a
`TensorParallel` holds this rank's Megatron slices of the float
projections: q/k/v, gate and up keep 1/tp of their output features, o_proj
and down_proj 1/tp of their input features and all-reduce their products
over the model group. Attention then runs on this rank's nh/tp query and
nkv/tp KV heads, and the KV caches hold those heads (`cache_heads`). Where
tp does not divide nkv the q/k/v slices are all-gathered first and every
rank attends all heads, as JAX's program still computes there. The int8
projections stay whole on every rank (JAX's rules replicate `kernel_q`).

Two things differ in how, not in what, is computed. The cache is updated in
place (the JAX module returns a new one). Attention spans only the first
`kv_len` cache rows, where `kv_len` is a bound the caller knows on the
largest position written + 1: every key past it is masked for every query,
and a masked key adds exactly 0 after `exp(-1e30 - max)`, so only the order
of the sums changes. `ops.causal_attention` computes it. On the card, where
a call's query rows fill one of its tiles (a prefill, a prefill segment, a
prefix hit's suffix, LLaVA's embeds, the judge's prompts), that is the
kernel `csrc/flash_prefill.cu`: one fused causal pass a layer over the
cache's rows, the heads that share a KV head together, Q·Kᵀ on the tensor
cores exact in f32, P carried at 24 bits against V, the softmax in f32;
key tiles past the causal edge and query tiles wholly past the prompt's
last written row are skipped. Elsewhere (the CPU, a decode step's 1 + k
rows) it is the plain twin: f32 einsums in blocks of query rows of at most
`ATTN_BLOCK_BYTES` of logits, so a long prompt never materialises
`[B, KV, S, group, max_seq_len]` f32 logits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from ..ops.causal_attention import causal_attention, kernel_rows
from ..parallel.collectives import gather_rows
from .sharding import split_size


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32_000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int | None = None     # defaults to hidden // heads
    intermediate_size: int = 14_336
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 4096
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # weight-only int8: projection kernels stored int8 + per-output-channel
    # f32 scales, widened inside each product
    quantize_weights: bool = False
    # int8 KV cache: K/V stored int8 + a per-(position, kv-head) f32 scale
    quantize_kv: bool = False

    @property
    def dh(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, **kw) -> "DecoderConfig":
        defaults = dict(
            vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=128, max_seq_len=128,
            rope_theta=10_000.0,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def mistral_nemo_12b(cls) -> "DecoderConfig":
        """The reference's generator model class (Mistral-Nemo 12B)."""
        return cls(
            vocab_size=131_072, hidden_size=5120, num_layers=40,
            num_heads=32, num_kv_heads=8, head_dim=128,
            intermediate_size=14_336, rope_theta=1_000_000.0,
            max_seq_len=16_384,
        )


class RMSNorm(nn.Module):
    def __init__(self, size: int, eps: float, param_dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size, dtype=param_dtype))

    def forward(self, x):
        xf = _as(x, torch.float32)
        norm = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True)
                                + self.eps)
        return _as(norm * _as(self.weight, torch.float32), x.dtype)


def rope_tables(positions, dh: int, theta: float):
    """positions [B, S] → (cos, sin) [B, S, 1, dh // 2] in f32: the angles
    `position · theta^(-i / half)`."""
    half = dh // 2
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32),
                      -torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions[:, :, None].float() * freqs
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rope(x, tables):
    """x: [B, S, H, Dh] → rotated x (pairwise halves, HF Llama convention:
    rotate_half), in f32 and cast back; `tables` are `rope_tables` of the
    positions."""
    half = x.shape[-1] // 2
    cos, sin = tables
    xf = _as(x, torch.float32)
    xf1, xf2 = xf[..., :half], xf[..., half:]
    return _as(torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                         dim=-1), x.dtype)


class Dense(nn.Module):
    """Flax `nn.Dense(use_bias=False, dtype, param_dtype)`: the input and
    the kernel cast to `dtype`, the product in `dtype`."""

    def __init__(self, in_features: int, features: int, dtype,
                 param_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features, dtype=param_dtype))

    def forward(self, x):
        return F.linear(_as(x, self.dtype), _as(self.weight, self.dtype))


class QuantDense(nn.Module):
    """Weight-only int8 linear: y = (x · W_i8) ⊙ scale, the int8 kernel
    [out, in] widened to `dtype` for the product, the per-output-channel
    f32 scale cast to `dtype`."""

    def __init__(self, in_features: int, features: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight_q", torch.empty(
            features, in_features, dtype=torch.int8))
        self.register_buffer("scale", torch.empty(features,
                                                  dtype=torch.float32))

    def forward(self, x):
        y = F.linear(_as(x, self.dtype), self.weight_q.to(self.dtype))
        return y * _as(self.scale, self.dtype)


class Embed(nn.Module):
    """Flax `nn.Embed(dtype, param_dtype)`: rows looked up, then cast."""

    def __init__(self, num: int, features: int, dtype,
                 param_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, features,
                                               dtype=param_dtype))

    def forward(self, ids):
        return _as(F.embedding(ids, self.weight), self.dtype)

    def attend(self, query):
        return F.linear(_as(query, self.dtype), _as(self.weight, self.dtype))


def _as(x, dtype):
    """`x.to(dtype)`, without a call where x has it (a decode step makes
    hundreds of these)."""
    return x if x.dtype == dtype else x.to(dtype)


def _linear(cfg: DecoderConfig, in_features: int, features: int):
    if cfg.quantize_weights:
        return QuantDense(in_features, features, cfg.dtype)
    return Dense(in_features, features, cfg.dtype, cfg.param_dtype)


def quantize_decoder_params(params: dict) -> dict:
    """float param tree (Dense kernels) → QuantDense tree (kernel_q +
    scale), host-side numpy, layer by layer (no double residency): each
    kernel is widened to a new f32 array (BF16 snapshot words exactly, by
    `convert.float32_leaf`, which refuses integer arrays), quantized in
    place and dropped before the next. The values are the JAX function's:
    max |w| is max(max w, −min w), and the division, rounding and clip
    are the same f32 operations."""
    from .convert import float32_leaf

    def rec(node):
        if isinstance(node, dict):
            if "kernel" in node and getattr(node["kernel"], "ndim", 0) == 2:
                w = float32_leaf(node["kernel"])
                amax = np.maximum(
                    np.maximum(w.max(axis=0), -w.min(axis=0)), 1e-12)
                scale = (amax / 127.0).astype(np.float32)
                np.divide(w, scale[None, :], out=w)
                np.round(w, out=w)
                np.clip(w, -127, 127, out=w)
                return {"kernel_q": w.astype(np.int8), "scale": scale}
            return {k: rec(v) for k, v in node.items()}
        return node

    out = {}
    for key, value in params.items():
        if key in ("embed_tokens",):  # embeddings stay float
            out[key] = value
        else:
            out[key] = rec(value)
    return out


@dataclasses.dataclass
class Frame:
    """What every layer of one forward shares: the positions [B, S] and
    their rotary tables, where the fresh K/V rows land in the caches (`rows`
    [B, S] of batch rows `bidx`: the window `lax.dynamic_update_slice`
    writes, its start clamped to max_len − S) and how many key rows are
    attended (`kv_len`: S without a cache); on the card, what the
    attention kernel reads of the rows (`attn_rows`: `kernel_rows`)."""
    positions: torch.Tensor
    tables: tuple
    kv_len: int
    rows: torch.Tensor | None = None
    bidx: torch.Tensor | None = None
    attn_rows: tuple | None = None

    @classmethod
    def make(cls, cfg: DecoderConfig, positions, max_len: int | None = None,
             kv_len: int | None = None, write_mask=None) -> "Frame":
        """`max_len`: the caches' rows (None: no cache); `kv_len` bounds the
        cache rows attended (default all of them); `write_mask` [B, S]: the
        rows that write the cache."""
        b, s = positions.shape
        tables = rope_tables(positions, cfg.dh, cfg.rope_theta)
        attn_rows = (kernel_rows(positions, write_mask)
                     if positions.is_cuda else None)
        if max_len is None:
            return cls(positions, tables, s, attn_rows=attn_rows)
        dev = positions.device
        start = positions[:, 0].clamp(0, max_len - s)
        return cls(positions, tables,
                   max_len if kv_len is None else min(int(kv_len), max_len),
                   rows=start[:, None] + torch.arange(s, device=dev),
                   bidx=torch.arange(b, device=dev)[:, None],
                   attn_rows=attn_rows)


def _tp_of(cfg: DecoderConfig, tp):
    """The model axis this module's projections are split over, or None
    where they are whole: no TP, a TP of one, or int8 projections."""
    if tp is None or tp.size == 1 or cfg.quantize_weights:
        return None
    return tp


def _all_reduce(x, tp):
    if tp is not None:
        dist.all_reduce(x, group=tp.group)
    return x


def _write_rows(cache, frame: Frame, values):
    """cache[b, rows[b, s]] = values[b, s] for every row b: the window of
    one `dynamic_update_slice` a row."""
    cache[frame.bidx, frame.rows] = _as(values, cache.dtype)


class GQAttention(nn.Module):
    def __init__(self, config: DecoderConfig, tp=None):
        super().__init__()
        cfg = self.config = config
        nh, nkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.dh
        h = cfg.hidden_size
        self.tp = tp = _tp_of(cfg, tp)
        qf, kvf = nh * dh, nkv * dh
        if tp is not None:
            qf, kvf = (split_size(qf, tp, "nh·dh"),
                       split_size(kvf, tp, "nkv·dh"))
        # heads attended here: this rank's, or all of them after a gather
        self.gather = tp is not None and nkv % tp.size != 0
        self.heads = ((nh // tp.size, nkv // tp.size)
                      if tp is not None and not self.gather else (nh, nkv))
        self.q_proj = _linear(cfg, h, qf)
        self.k_proj = _linear(cfg, h, kvf)
        self.v_proj = _linear(cfg, h, kvf)
        self.o_proj = _linear(cfg, qf, h)

    def forward(self, hidden, frame: Frame, cache=None, attn_mask=None,
                write_mask=None):
        """hidden [B, S, H]; `frame` is `Frame.make` of the positions, shared
        by every layer; write_mask [B, S] zeroes the K/V rows of padding
        tokens; cache: None | dict(k [B, max, KV, Dh], v (, k_scale,
        v_scale)) — the fresh rows are written in place and attention spans
        the first `frame.kv_len` rows; returns (out, cache)."""
        cfg = self.config
        b, s, _ = hidden.shape
        (nh, nkv), dh = self.heads, cfg.dh
        kv_len = frame.kv_len
        q, k, v = (lin(hidden) for lin in
                   (self.q_proj, self.k_proj, self.v_proj))
        if self.gather:
            q, k, v = (gather_rows(x, self.tp, dim=-1) for x in (q, k, v))
        q = rope(q.reshape(b, s, nh, dh), frame.tables)
        k = rope(k.reshape(b, s, nkv, dh), frame.tables)
        v = v.reshape(b, s, nkv, dh)

        if cache is not None:
            if write_mask is not None:
                k = k * write_mask[:, :, None, None].to(k.dtype)
                v = v * write_mask[:, :, None, None].to(v.dtype)
            if cfg.quantize_kv:
                for name, t in (("k", k), ("v", v)):
                    tf = t.float()
                    scale = tf.abs().amax(dim=-1) / 127.0   # [B, S, KV]
                    safe = torch.where(scale > 0, scale, 1.0)
                    qt = torch.clamp(torch.round(tf / safe[..., None]),
                                     -127, 127).to(torch.int8)
                    _write_rows(cache[name], frame, qt)
                    _write_rows(cache[name + "_scale"], frame, scale)
                dq = cfg.dtype
                k_all = cache["k"][:, :kv_len].to(dq) \
                    * cache["k_scale"][:, :kv_len, :, None].to(dq)
                v_all = cache["v"][:, :kv_len].to(dq) \
                    * cache["v_scale"][:, :kv_len, :, None].to(dq)
            else:
                _write_rows(cache["k"], frame, k)
                _write_rows(cache["v"], frame, v)
                k_all = cache["k"][:, :kv_len]
                v_all = cache["v"][:, :kv_len]
        else:
            k_all, v_all = k, v

        # write_mask marks padding rows only where it guards a cache write
        ctx = causal_attention(q, k_all, v_all, frame.positions,
                               None if cache is None else write_mask,
                               attn_mask, frame.attn_rows)
        ctx = ctx.reshape(b, s, nh * dh)
        if self.gather:   # this rank's input features of o_proj
            per = nh * dh // self.tp.size
            ctx = ctx[..., self.tp.rank * per:(self.tp.rank + 1) * per]
        out = _all_reduce(self.o_proj(_as(ctx, cfg.dtype)), self.tp)
        return out, cache


class DecoderLayer(nn.Module):
    def __init__(self, config: DecoderConfig, tp=None):
        super().__init__()
        cfg = self.config = config
        h, f = cfg.hidden_size, cfg.intermediate_size
        self.tp = _tp_of(cfg, tp)
        if self.tp is not None:
            f = split_size(f, self.tp, "intermediate_size")
        self.input_norm = RMSNorm(h, cfg.rms_norm_eps, cfg.param_dtype)
        self.attention = GQAttention(cfg, tp)
        self.post_attention_norm = RMSNorm(h, cfg.rms_norm_eps,
                                           cfg.param_dtype)
        self.gate_proj = _linear(cfg, h, f)
        self.up_proj = _linear(cfg, h, f)
        self.down_proj = _linear(cfg, f, h)

    def forward(self, hidden, frame: Frame, cache=None, attn_mask=None,
                write_mask=None):
        attn_out, cache = self.attention(self.input_norm(hidden), frame,
                                         cache, attn_mask, write_mask)
        hidden = hidden + attn_out
        mlp_in = self.post_attention_norm(hidden)
        gate = F.silu(self.gate_proj(mlp_in))
        hidden = hidden + _all_reduce(
            self.down_proj(gate * self.up_proj(mlp_in)), self.tp)
        return hidden, cache


class DecoderModel(nn.Module):
    """→ logits [B, S, V] (+ the caches, written in place, when passed).
    `tp`: this rank's `models.sharding.TensorParallel`, or None."""

    def __init__(self, config: DecoderConfig, tp=None):
        super().__init__()
        cfg = self.config = config
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype,
                                  cfg.param_dtype)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(cfg, tp))
        # the KV heads each cache holds on this rank
        self.cache_heads = self.layer_0.attention.heads[1] \
            if cfg.num_layers else cfg.num_kv_heads
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                  cfg.param_dtype)
        if not cfg.tie_embeddings:
            self.lm_head = (
                QuantDense(cfg.hidden_size, cfg.vocab_size, torch.float32)
                if cfg.quantize_weights else
                Dense(cfg.hidden_size, cfg.vocab_size, torch.float32,
                      cfg.param_dtype))

    def layers(self):
        return [getattr(self, f"layer_{i}")
                for i in range(self.config.num_layers)]

    def forward(self, input_ids, positions=None, caches=None,
                attn_mask=None, write_mask=None, last_index=None,
                kv_len=None, inputs_embeds=None):
        """`kv_len` (host int) bounds the cache rows attended: it must be
        above every position of `positions` (the keys past it are masked
        for every query). `inputs_embeds` [B, S, H] (the multimodal path,
        models/llava.py: token embeddings with projected image patches
        spliced in) replaces the embedding lookup, cast to `config.dtype`;
        `input_ids` is then ignored (None is fine)."""
        cfg = self.config
        if inputs_embeds is not None:
            b, s = inputs_embeds.shape[:2]
            hidden = _as(inputs_embeds, cfg.dtype)
        else:
            b, s = input_ids.shape
            hidden = self.embed_tokens(input_ids)
        if positions is None:
            positions = torch.arange(s, device=hidden.device).expand(b, s)
        frame = Frame.make(cfg, positions, None if caches is None
                           else caches[0]["k"].shape[1], kv_len,
                           None if caches is None else write_mask)
        for i, layer in enumerate(self.layers()):
            hidden, _ = layer(hidden, frame,
                              caches[i] if caches is not None else None,
                              attn_mask, write_mask)
        hidden = self.final_norm(hidden)
        if last_index is not None:
            # the LM head only at each row's last valid position
            hidden = hidden[torch.arange(b, device=hidden.device),
                            last_index.long()][:, None]
        if cfg.tie_embeddings:
            logits = self.embed_tokens.attend(hidden.float())
        else:
            logits = self.lm_head(hidden.float())
        if caches is not None:
            return logits, caches
        return logits

    @staticmethod
    def init_cache(cfg: DecoderConfig, batch: int,
                   length: int | None = None, device=None,
                   kv_heads: int | None = None):
        # `length` bounds the cache rows (default: full context);
        # `kv_heads` the heads (default all: a TP model's `cache_heads`)
        kv_shape = (batch, length or cfg.max_seq_len,
                    kv_heads or cfg.num_kv_heads, cfg.dh)
        if cfg.quantize_kv:
            sc_shape = kv_shape[:-1]
            return [
                {
                    "k": torch.zeros(kv_shape, dtype=torch.int8,
                                     device=device),
                    "k_scale": torch.zeros(sc_shape, dtype=torch.float32,
                                           device=device),
                    "v": torch.zeros(kv_shape, dtype=torch.int8,
                                     device=device),
                    "v_scale": torch.zeros(sc_shape, dtype=torch.float32,
                                           device=device),
                }
                for _ in range(cfg.num_layers)
            ]
        return [
            {"k": torch.zeros(kv_shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(kv_shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.num_layers)
        ]


def build_decoder(cfg: DecoderConfig, device, tp=None) -> DecoderModel:
    """The module with its parameters allocated on `device` and not yet
    filled: random init or a loaded tree fills them. `tp`: this rank's
    `TensorParallel` (its slices are allocated)."""
    with torch.device(device):
        model = DecoderModel(cfg, tp)
    return model.requires_grad_(False).eval()


def init_random_(model: DecoderModel, seed: int = 0) -> DecoderModel:
    """Seeded random init in place, on the model's device, as the JAX
    module's `model.init(jax.random.key(seed), ...)` makes it
    (`models.flax_init` over `decoder_flax_tree`): Dense kernels
    lecun_normal (a normal truncated at ±2σ), Embed tables normal with std
    1/sqrt(features), RMSNorm scales 1, QuantDense kernels `clip(round(
    normal · 42), ±127)` with scales 0.01. A TP model draws its own slices
    of each whole tensor."""
    from .flax_init import init_flax_tree_, module_tp

    init_flax_tree_(decoder_flax_tree(model), seed, module_tp(model))
    return model


def decoder_flax_tree(model: DecoderModel) -> dict:
    """The model's parameters as the Flax tree `load_decoder_params` reads
    ({'params': ...}; kernels transposed, `kernel_q` / `scale` for int8
    projections), the leaves torch views on the model's device: what
    `models.sharding.shard_params` slices without a host copy."""
    tree: dict = {}
    for scope, sub in model.named_modules():
        if isinstance(sub, QuantDense):
            leaves = {"kernel_q": sub.weight_q.T, "scale": sub.scale}
        elif isinstance(sub, Dense):
            leaves = {"kernel": sub.weight.T}
        elif isinstance(sub, Embed):
            leaves = {"embedding": sub.weight}
        elif isinstance(sub, RMSNorm):
            leaves = {"scale": sub.weight}
        else:
            continue
        node = tree
        for part in scope.split("."):
            node = node.setdefault(part, {})
        node.update({k: v.detach() for k, v in leaves.items()})
    return {"params": tree}


def load_decoder_params(model: DecoderModel, tree: dict) -> DecoderModel:
    """A Flax `DecoderModel` tree ({'params': ...} or bare; float or
    `kernel_q`/`scale` leaves) into `model`. An `lm_head` the tied model
    has no use for is left out, as Flax's apply ignores it."""
    from .convert import load_flax_params

    if set(tree) == {"params"}:
        tree = tree["params"]
    if model.config.tie_embeddings:
        tree = {k: v for k, v in tree.items() if k != "lm_head"}
    return load_flax_params(model, tree)
