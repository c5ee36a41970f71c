"""A Mistral-style decoder's products (keys as in its `config.json`):
GQA attention and a SwiGLU MLP, the embedding table as the head. Prefill
computes the head at the last prompt position only; a decoded token at
position p attends p + 1 cache rows (its own included)."""

from __future__ import annotations


def layer_params(m: dict) -> int:
    """Projection parameters of one layer."""
    h, f = m["hidden_size"], m["intermediate_size"]
    q = m["num_attention_heads"] * m["head_dim"]
    kv = m["num_key_value_heads"] * m["head_dim"]
    return h * q + 2 * h * kv + q * h + 3 * h * f


def head_flops(m: dict) -> int:
    return 2 * m["vocab_size"] * m["hidden_size"]


def prefill_flops(m: dict, n: int) -> int:
    """Products of a causal prefill of n tokens, with the head at its last
    position."""
    attn = 2 * m["head_dim"] * m["num_attention_heads"] * n * (n + 1)
    return m["num_hidden_layers"] * (2 * n * layer_params(m) + attn) \
        + head_flops(m)


def decode_flops(m: dict, pos: int) -> int:
    """Products of one decoded token at position `pos`."""
    attn = 4 * m["head_dim"] * m["num_attention_heads"] * (pos + 1)
    return m["num_hidden_layers"] * (2 * layer_params(m) + attn) \
        + head_flops(m)

