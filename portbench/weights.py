"""The benchmark's weights, made on the device from the seed.

Each leaf has a generator of its own, seeded from (seed, the leaf's name),
so any leaf can be made again alone: the port gets the whole tree at
set-up, and the reference makes each layer again after the window,
without a second copy of the model on the card. Leaves are made in the
type they are served in (int8 projections with f32 channel scales for
the decoder, f32 for the encoders), a few large draws each.
"""

from __future__ import annotations

import hashlib
import math

import torch

# int8 kernels: round(N(0, 1) · QSTD) clipped to ±127, so the codes use
# the int8 range as a quantized normal kernel does
QSTD = 42.0


def generator(seed: int, name: str, device) -> torch.Generator:
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") & (2 ** 63 - 1))
    return g


def normal(shape, seed: int, name: str, device, std: float = 1.0,
           mean: float = 0.0) -> torch.Tensor:
    g = generator(seed, name, device)
    x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    if std != 1.0:
        x.mul_(std)
    if mean:
        x.add_(mean)
    return x


def int8_kernel(out_f: int, in_f: int, seed: int, name: str, device
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes [out, in] int8, scales [out] f32): the channel's weights are
    codes · scale, of standard deviation ~1/sqrt(in)."""
    g = generator(seed, name, device)
    codes = torch.randn((out_f, in_f), generator=g, device=device,
                        dtype=torch.float32)
    codes = codes.mul_(QSTD).round_().clamp_(-127, 127).to(torch.int8)
    scale = torch.rand((out_f,), generator=g, device=device,
                       dtype=torch.float32)
    scale = scale.mul_(0.5).add_(0.75).div_(QSTD * math.sqrt(in_f))
    return codes, scale


# ------------------------------------------------------------- decoder
PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
               "up_proj", "down_proj")


def projection_shape(m: dict, name: str) -> tuple[int, int]:
    """(out, in) of a decoder projection, keys as in `config.json`."""
    h, f = m["hidden_size"], m["intermediate_size"]
    q = m["num_attention_heads"] * m["head_dim"]
    kv = m["num_key_value_heads"] * m["head_dim"]
    return {"q_proj": (q, h), "k_proj": (kv, h), "v_proj": (kv, h),
            "o_proj": (h, q), "gate_proj": (f, h), "up_proj": (f, h),
            "down_proj": (h, f)}[name]


def decoder_layer(m: dict, seed: int, i: int, device) -> dict:
    """Layer i: {projection: (codes [out, in], scales [out]),
    "input_norm": [H], "post_attention_norm": [H]}."""
    out = {p: int8_kernel(*projection_shape(m, p), seed,
                          f"layer_{i}.{p}", device) for p in PROJECTIONS}
    for norm in ("input_norm", "post_attention_norm"):
        out[norm] = normal((m["hidden_size"],), seed, f"layer_{i}.{norm}",
                           device, std=0.1, mean=1.0)
    return out


def decoder_table(m: dict, seed: int, device) -> torch.Tensor:
    """The f32 embedding table [V, H], also the head."""
    h = m["hidden_size"]
    return normal((m["vocab_size"], h), seed, "embed_tokens", device,
                  std=1.0 / math.sqrt(h))


def decoder_final_norm(m: dict, seed: int, device) -> torch.Tensor:
    return normal((m["hidden_size"],), seed, "final_norm", device,
                  std=0.1, mean=1.0)


def decoder_tree(m: dict, seed: int, device) -> dict:
    """The whole model as the port's load path reads it (a Flax tree:
    kernels [in, out], here transposed views of the [out, in] codes)."""
    tree = {"embed_tokens": {"embedding": decoder_table(m, seed, device)},
            "final_norm": {"scale": decoder_final_norm(m, seed, device)}}
    for i in range(m["num_hidden_layers"]):
        layer = decoder_layer(m, seed, i, device)
        node = {"input_norm": {"scale": layer["input_norm"]},
                "post_attention_norm": {"scale":
                                        layer["post_attention_norm"]},
                "attention": {}}
        for p in PROJECTIONS:
            codes, scale = layer[p]
            leaf = {"kernel_q": codes.T, "scale": scale}
            if p in ("q_proj", "k_proj", "v_proj", "o_proj"):
                node["attention"][p] = leaf
            else:
                node[p] = leaf
        tree[f"layer_{i}"] = node
    return {"params": tree}


# ------------------------------------------------------------- encoders
def xlmr_shapes(c: dict, head: str) -> dict:
    """{name: shape} of an XLM-RoBERTa encoder (keys as its `config.json`)
    with BGE-M3's heads (`head="m3"`: the sparse and ColBERT projections)
    or the cross-encoder's (`"rerank"`: dense, then the scalar out)."""
    h, f = c["hidden_size"], c["intermediate_size"]
    out = {"word_embeddings": (c["vocab_size"], h),
           "position_embeddings": (c["max_position_embeddings"], h),
           "token_type_embeddings": (c["type_vocab_size"], h),
           "embeddings_norm.weight": (h,), "embeddings_norm.bias": (h,)}
    for i in range(c["num_hidden_layers"]):
        p = f"layer_{i}."
        for name in ("query", "key", "value", "output"):
            out[f"{p}attention.{name}.weight"] = (h, h)
            out[f"{p}attention.{name}.bias"] = (h,)
        out[f"{p}intermediate.weight"] = (f, h)
        out[f"{p}intermediate.bias"] = (f,)
        out[f"{p}mlp_output.weight"] = (h, f)
        out[f"{p}mlp_output.bias"] = (h,)
        for norm in ("attention_norm", "output_norm"):
            out[f"{p}{norm}.weight"] = (h,)
            out[f"{p}{norm}.bias"] = (h,)
    if head == "m3":
        out.update({"sparse_head.weight": (1, h), "sparse_head.bias": (1,),
                    "colbert_head.weight": (c["colbert_dim"], h),
                    "colbert_head.bias": (c["colbert_dim"],)})
    else:
        out.update({"head_dense.weight": (h, h), "head_dense.bias": (h,),
                    "classifier.weight": (1, h), "classifier.bias": (1,)})
    return out


def xlmr_leaf(c: dict, head: str, seed: int, model: str, name: str,
              device) -> torch.Tensor:
    """One f32 leaf of model `model` ("embedder" or "reranker"): kernels
    N(0, 1/in), embeddings N(0, 0.02²), biases N(0, 0.02²), LayerNorm
    scales 1 + N(0, 0.05²)."""
    shape = xlmr_shapes(c, head)[name]
    key = f"{model}.{name}"
    if name.endswith("norm.weight"):
        return normal(shape, seed, key, device, std=0.05, mean=1.0)
    if name.endswith(".weight") and len(shape) == 2:
        return normal(shape, seed, key, device, std=1.0 / math.sqrt(
            shape[1]))
    return normal(shape, seed, key, device, std=0.02)


def xlmr_tree(c: dict, head: str, seed: int, model: str, device) -> dict:
    """The model as the port's load path reads it: a Flax tree, the
    encoder under `encoder`, kernels [in, out] (transposed views)."""
    tree: dict = {}
    for name in xlmr_shapes(c, head):
        value = xlmr_leaf(c, head, seed, model, name, device)
        parts = name.split(".")
        leaf = parts.pop() if parts[-1] in ("weight", "bias") else None
        if leaf is None:
            parts, key = parts, "embedding"
        elif value.ndim == 2:
            key, value = "kernel", value.T
        elif leaf == "weight":
            key = "scale"
        else:
            key = "bias"
        if not parts[0].endswith("_head") and parts[0] not in (
                "head_dense", "classifier"):
            parts = ["encoder", *parts]
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[key] = value
    return {"params": tree}
