"""A Mistral-style decoder's forward pass in plain PyTorch.

The published architecture: token embedding, then per layer RMSNorm,
grouped-query attention with rotary positions (rotate_half, angles
position · θ^(-i/half) in f64), a residual add, RMSNorm, a SwiGLU MLP
(down(silu(gate(x)) · up(x))) and a residual add; a final RMSNorm and the
embedding table as the head. Causal, no cache, no batching: each sequence
over all its positions, attention in blocks of query rows. The layers are
the outer loop, so each layer's weights are made once for all the
sequences compared.

The weights are the benchmark's (`portbench.weights`), dequantized here
from their int8 codes and channel scales to float32. The projections are
TF32 products with float32 sums: 10-bit mantissas, finer than the
bfloat16 products the configuration states for them. Attention, the
norms and the head are float32 without TF32. The controls, one step below
what the configuration states: `precision="fp8"` rounds every
projection's input to float8 e4m3 with a per-row scale (an FP8
activation path in place of bfloat16); `precision="int4"` re-quantizes
every int8 projection to int4 codes with a per-output-channel scale (a
W4A16 path).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch.nn import functional as F

from .precision import fp8_rows, tf32

ATTN_BLOCK = 512


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope_tables(n: int, dh: int, theta: float, device):
    half = dh // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64) / half)
    ang = torch.arange(n, dtype=torch.float64)[:, None] * inv
    return (torch.cos(ang).float().to(device),
            torch.sin(ang).float().to(device))


def rope(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """x [n, heads, dh]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def causal_attention(q, k, v) -> torch.Tensor:
    """q [n, nh, dh], k/v [n, nkv, dh] → [n, nh · dh], each query over the
    keys at or before its position, in blocks of query rows."""
    n, nh, dh = q.shape
    group = nh // k.shape[1]
    kx = k.repeat_interleave(group, dim=1).transpose(0, 1)   # [nh, n, dh]
    vx = v.repeat_interleave(group, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1)
    out = torch.empty((nh, n, dh), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(dh)
    for i in range(0, n, ATTN_BLOCK):
        j = min(i + ATTN_BLOCK, n)
        s = torch.matmul(qh[:, i:j], kx[:, :j].transpose(1, 2)) * scale
        pos_q = torch.arange(i, j, device=q.device)[:, None]
        pos_k = torch.arange(j, device=q.device)[None, :]
        s = s.masked_fill(pos_k > pos_q, float("-inf"))
        out[:, i:j] = torch.matmul(torch.softmax(s, dim=-1), vx[:, :j])
    return out.transpose(0, 1).reshape(n, nh * dh)


def forward_logits(m: dict, layer: Callable[[int], dict],
                   table: torch.Tensor, final_norm: torch.Tensor,
                   ids: Sequence[int], positions: Sequence[int],
                   precision: str = "f32") -> torch.Tensor:
    """The logits [len(positions), V] at `positions` of the sequence `ids`.
    `layer(i)` gives layer i's weights as `portbench.weights.decoder_layer`
    makes them; `table` is the f32 embedding table."""
    return forward_many(m, layer, table, final_norm, [(ids, positions)],
                        precision)[0]


def forward_many(m: dict, layer: Callable[[int], dict],
                 table: torch.Tensor, final_norm: torch.Tensor,
                 seqs: Sequence[tuple[Sequence[int], Sequence[int]]],
                 precision: str = "f32") -> list[torch.Tensor]:
    """`forward_logits` of every (ids, positions) in `seqs`, layer by
    layer: the hidden rows of all the sequences stay on the device
    between layers."""
    if precision not in ("f32", "fp8", "int4"):
        raise ValueError(f"unknown precision {precision!r}")
    dev = table.device
    eps = m["rms_norm_eps"]
    nh, nkv, dh = (m["num_attention_heads"], m["num_key_value_heads"],
                   m["head_dim"])

    def dequantize(w):
        codes, scale = w
        w = codes.float() * scale[:, None]
        if precision == "int4":
            step = w.abs().amax(dim=1, keepdim=True).clamp_min(1e-30) / 7
            w = (w / step).round_().clamp_(-7, 7) * step
        return w

    def product(x, w):
        if precision == "fp8":
            x = fp8_rows(x)
        with tf32(True):
            return F.linear(x, w)

    ids = [torch.as_tensor(list(i), dtype=torch.long, device=dev)
           for i, _ in seqs]
    longest = max(int(t.shape[0]) for t in ids)
    cos, sin = rope_tables(longest, dh, m["rope_theta"], dev)
    with tf32(False), torch.no_grad():
        xs = [table[t].float() for t in ids]
        for i in range(m["num_hidden_layers"]):
            w = {k: dequantize(v) if isinstance(v, tuple) else v
                 for k, v in layer(i).items()}
            for j, x in enumerate(xs):
                n = x.shape[0]
                c, s = cos[:n], sin[:n]
                h = rms_norm(x, w["input_norm"], eps)
                q = rope(product(h, w["q_proj"]).view(n, nh, dh), c, s)
                k = rope(product(h, w["k_proj"]).view(n, nkv, dh), c, s)
                v = product(h, w["v_proj"]).view(n, nkv, dh)
                x = x + product(causal_attention(q, k, v), w["o_proj"])
                del q, k, v
                h = rms_norm(x, w["post_attention_norm"], eps)
                xs[j] = x + product(F.silu(product(h, w["gate_proj"]))
                                    * product(h, w["up_proj"]),
                                    w["down_proj"])
                del h, x
            del w
        out = []
        for x, (_, positions) in zip(xs, seqs):
            pos = torch.as_tensor(list(positions), dtype=torch.long,
                                  device=dev)
            out.append(F.linear(rms_norm(x[pos], final_norm, eps), table))
        return out


def served_gaps(logits: torch.Tensor, tokens: Sequence[int]) -> list[float]:
    """How far below each position's best logit the token taken there
    lies (0 where it is the best)."""
    t = torch.as_tensor(list(tokens), dtype=torch.long,
                        device=logits.device)
    best = logits.max(dim=-1).values
    return (best - logits.gather(1, t[:, None])[:, 0]).tolist()
