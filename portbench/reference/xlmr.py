"""XLM-RoBERTa (BGE-M3's backbone and bge-reranker-v2-m3's) in plain
PyTorch, float32.

Embeddings (word + position counted from the pad id + token type 0) and
a LayerNorm; per layer, post-LN: multi-head self-attention over each row's
valid tokens, residual, LayerNorm, GELU (exact erf) MLP, residual,
LayerNorm. BGE-M3's dense vector is the L2-normalised CLS state; the
cross-encoder's score is sigmoid(out_proj(tanh(dense(CLS)))). Rows one
at a time, padding never computed. TF32 is off, or on for the control
(`precision="tf32"`).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch.nn import functional as F

from .precision import tf32


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def encode(c: dict, leaf: Callable[[str], torch.Tensor],
           ids: Sequence[int]) -> torch.Tensor:
    """The final hidden states [n, H] of one row of valid ids. `leaf(name)`
    gives a weight by its name in `portbench.weights.xlmr_leaves`."""
    dev = leaf("word_embeddings").device
    eps, heads = c["layer_norm_eps"], c["num_attention_heads"]
    t = torch.as_tensor(list(ids), dtype=torch.long, device=dev)
    n = t.shape[0]
    pos = torch.arange(n, device=dev) + c["pad_token_id"] + 1
    x = (leaf("word_embeddings")[t] + leaf("position_embeddings")[pos]
         + leaf("token_type_embeddings")[0])
    x = layer_norm(x, leaf("embeddings_norm.weight"),
                   leaf("embeddings_norm.bias"), eps)
    h = x.shape[-1]
    dh = h // heads
    for i in range(c["num_hidden_layers"]):
        def lin(name, v, i=i):
            return F.linear(v, leaf(f"layer_{i}.{name}.weight"),
                            leaf(f"layer_{i}.{name}.bias"))

        q, k, v = (lin(f"attention.{p}", x).view(n, heads, dh)
                   .transpose(0, 1) for p in ("query", "key", "value"))
        s = torch.matmul(q, k.transpose(1, 2)) / math.sqrt(dh)
        ctx = torch.matmul(torch.softmax(s, dim=-1), v)
        ctx = ctx.transpose(0, 1).reshape(n, h)
        x = layer_norm(x + lin("attention.output", ctx),
                       leaf(f"layer_{i}.attention_norm.weight"),
                       leaf(f"layer_{i}.attention_norm.bias"), eps)
        mlp = lin("mlp_output", F.gelu(lin("intermediate", x)))
        x = layer_norm(x + mlp, leaf(f"layer_{i}.output_norm.weight"),
                       leaf(f"layer_{i}.output_norm.bias"), eps)
    return x


def dense_vector(c, leaf, ids, precision: str = "f32") -> torch.Tensor:
    with tf32(precision == "tf32"), torch.no_grad():
        cls = encode(c, leaf, ids)[0]
        return cls / cls.norm().clamp_min(1e-12)


def pair_score(c, leaf, ids, precision: str = "f32") -> float:
    with tf32(precision == "tf32"), torch.no_grad():
        cls = encode(c, leaf, ids)[0]
        hid = torch.tanh(F.linear(cls, leaf("head_dense.weight"),
                                  leaf("head_dense.bias")))
        logit = F.linear(hid, leaf("classifier.weight"),
                         leaf("classifier.bias"))
        return float(torch.sigmoid(logit)[0])
