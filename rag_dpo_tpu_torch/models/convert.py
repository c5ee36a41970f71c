"""Parameter trees of the JAX package ↔ the port's modules.

`load_params_npz` reads the npz format both packages share ('/'-joined Flax
paths, as written by `scripts/convert_weights.py` and the training recipe)
and `save_params_npz` writes it; `load_flax_params` copies a Flax tree
(numpy leaves) into a module, and `state_dict_to_flax` is its inverse:

* Dense `kernel [in, out]` → Linear `weight [out, in]`;
* QuantDense `kernel_q [in, out]` (int8, kept int8) → `weight_q [out, in]`,
  its `scale` → `scale`;
* LayerNorm and RMSNorm `scale` → `weight`; Embed `embedding` → `weight`;
* scope names map to submodule names one to one
  (`encoder/layer_0/attention/query` → `encoder.layer_0.attention.query`).

`convert_xlmr_state_dict`, `convert_bge_m3_state_dict`,
`convert_cross_encoder_state_dict`, `convert_llama_state_dict`,
`convert_clip_vision_state_dict` and `convert_llava_state_dict` map HF
`XLMRobertaModel` / `XLMRobertaForSequenceClassification` /
`LlamaForCausalLM` / `MistralForCausalLM` / `CLIPVisionModel` /
`LlavaForConditionalGeneration` state dicts (numpy arrays) onto that Flax
tree; they are the JAX package's pure-numpy converters, copied.
`models/convert_weights.py` runs them on a local snapshot.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from .encoder import LayerNorm


def flatten_params(tree: dict, prefix: str = "") -> dict:
    """Nested param tree → flat {'a/b/c': ndarray} (npz-serializable);
    torch tensor leaves stay tensors where they are."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.update(flatten_params(value, path))
        else:
            out[path] = (value if isinstance(value, torch.Tensor)
                         else np.asarray(value))
    return out


def save_params_npz(params: dict, path) -> None:
    """Bare Flax tree (no 'params' level) → npz, as the JAX package saves
    it; `state_dict_to_flax(model)` gives the tree of a port model."""
    np.savez(path, **flatten_params(params))


def load_params_npz(path) -> dict:
    """npz ('/'-joined keys) → {'params': nested tree} of numpy arrays."""
    tree: dict = {}
    for key, value in dict(np.load(path)).items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return {"params": tree}


def _as_type(value, dtype):
    """A numpy leaf as a writable copy in `dtype` (a numpy dtype); a torch
    leaf in that dtype on its device (no copy where it has it already)."""
    if isinstance(value, torch.Tensor):
        return value.to(torch.from_numpy(np.zeros(0, dtype)).dtype)
    return np.array(value, dtype)


def flax_to_state_dict(tree: dict) -> dict[str, np.ndarray]:
    """Flax tree ({'params': …} or bare) → torch state-dict names/layouts
    (numpy leaves, or torch tensors on their device where the tree holds
    tensors)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = flatten_params(tree)
    out = {}
    for path, value in flat.items():
        *scope, leaf = path.split("/")
        if leaf == "kernel_q":
            out[".".join([*scope, "weight_q"])] = _as_type(value, np.int8).T
            continue
        value = _as_type(value, np.float32)  # a writable copy
        if leaf == "kernel":
            leaf, value = "weight", value.T
        elif leaf == "scale" and "/".join([*scope, "kernel_q"]) in flat:
            pass                             # a QuantDense's channel scales
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        out[".".join([*scope, leaf])] = value
    return out


def state_dict_to_flax(module: nn.Module, state: dict | None = None
                       ) -> dict:
    """A module's parameters → the bare Flax tree of the JAX model (numpy
    f32 leaves): the inverse of `flax_to_state_dict`, which needs the
    module to tell a LayerNorm weight (`scale`) and an Embedding weight
    (`embedding`) from a Linear weight (`kernel`, transposed). `state`
    (name → tensor) gives the values instead of the module's own, e.g. a
    TP model's slices gathered whole."""
    def get(scope, name, own):
        return own if state is None else state[f"{scope}.{name}"]

    tree: dict = {}
    for scope, sub in module.named_modules():
        if isinstance(sub, nn.Linear):
            leaves = {"kernel": get(scope, "weight", sub.weight).T,
                      "bias": get(scope, "bias", sub.bias)}
        elif isinstance(sub, LayerNorm):
            leaves = {"scale": get(scope, "weight", sub.weight),
                      "bias": get(scope, "bias", sub.bias)}
        elif isinstance(sub, nn.Embedding):
            leaves = {"embedding": get(scope, "weight", sub.weight)}
        else:
            continue
        node = tree
        for part in scope.split("."):
            node = node.setdefault(part, {})
        for leaf, value in leaves.items():
            node[leaf] = np.ascontiguousarray(
                value.detach().float().cpu().numpy())
    return tree


def load_flax_params(module: nn.Module, tree: dict) -> nn.Module:
    """Copy a Flax parameter tree into `module` in place (strict: every
    parameter of the module must be present, and nothing else)."""
    state = flax_to_state_dict(tree)
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(f"Flax tree does not fit the module: missing "
                       f"{missing[:5]}, unexpected {unexpected[:5]}")
    with torch.no_grad():
        for name, value in state.items():
            dst = own[name]
            if tuple(dst.shape) != value.shape:
                raise ValueError(f"{name}: module {tuple(dst.shape)} vs "
                                 f"tree {value.shape}")
            dst.copy_(value if isinstance(value, torch.Tensor)
                      else torch.from_numpy(np.ascontiguousarray(value)))
    return module


# HF state dicts (name → numpy array) → Flax trees: copies of the JAX
# package's pure-numpy converters (held equal by tests/test_torch_convert.py)

def _set(tree: dict, path: tuple[str, ...], value):
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def convert_xlmr_state_dict(state: dict, prefix: str = "") -> dict:
    """torch state-dict (name → np.ndarray) → Flax param tree for
    `TransformerEncoder` (call with scope name 'encoder' stripped off by
    the caller's module nesting).

    Handles both bare `XLMRobertaModel` keys and `roberta.`-prefixed ones.
    Linear weights are transposed ([out,in] → [in,out]).
    """
    params: dict = {}

    def arr(name):
        v = state[prefix + name]
        return np.asarray(v)

    def has(name):
        return (prefix + name) in state

    # --- embeddings
    _set(params, ("word_embeddings", "embedding"),
         arr("embeddings.word_embeddings.weight"))
    _set(params, ("position_embeddings", "embedding"),
         arr("embeddings.position_embeddings.weight"))
    if has("embeddings.token_type_embeddings.weight"):
        _set(params, ("token_type_embeddings", "embedding"),
             arr("embeddings.token_type_embeddings.weight"))
    _set(params, ("embeddings_norm", "scale"),
         arr("embeddings.LayerNorm.weight"))
    _set(params, ("embeddings_norm", "bias"),
         arr("embeddings.LayerNorm.bias"))

    # --- layers
    layer_ids = sorted({
        int(m.group(1))
        for k in state
        if (m := re.search(r"encoder\.layer\.(\d+)\.", k))
    })
    for i in layer_ids:
        base = f"encoder.layer.{i}."
        lname = f"layer_{i}"
        for src, dst in (
            ("attention.self.query", ("attention", "query")),
            ("attention.self.key", ("attention", "key")),
            ("attention.self.value", ("attention", "value")),
            ("attention.output.dense", ("attention", "output")),
            ("intermediate.dense", ("intermediate",)),
            ("output.dense", ("mlp_output",)),
        ):
            _set(params, (lname, *dst, "kernel"),
                 arr(base + src + ".weight").T)
            _set(params, (lname, *dst, "bias"), arr(base + src + ".bias"))
        _set(params, (lname, "attention_norm", "scale"),
             arr(base + "attention.output.LayerNorm.weight"))
        _set(params, (lname, "attention_norm", "bias"),
             arr(base + "attention.output.LayerNorm.bias"))
        _set(params, (lname, "output_norm", "scale"),
             arr(base + "output.LayerNorm.weight"))
        _set(params, (lname, "output_norm", "bias"),
             arr(base + "output.LayerNorm.bias"))
    return params


def convert_bge_m3_state_dict(state: dict) -> dict:
    """Full BGE-M3 export (backbone + sparse/colbert heads) → BgeM3Model
    params. Head weights are published by FlagEmbedding as
    `sparse_linear.pt` / `colbert_linear.pt` alongside the backbone; pass
    them merged into `state` under 'sparse_linear.*' / 'colbert_linear.*'.
    """
    prefix = "roberta." if any(k.startswith("roberta.") for k in state) else ""
    params = {"encoder": convert_xlmr_state_dict(state, prefix)}
    if "sparse_linear.weight" in state:
        params["sparse_head"] = {
            "kernel": np.asarray(state["sparse_linear.weight"]).T,
            "bias": np.asarray(state["sparse_linear.bias"]),
        }
    if "colbert_linear.weight" in state:
        params["colbert_head"] = {
            "kernel": np.asarray(state["colbert_linear.weight"]).T,
            "bias": np.asarray(state["colbert_linear.bias"]),
        }
    return params


def convert_llama_state_dict(state: dict) -> dict:
    """HF `LlamaForCausalLM`/`MistralForCausalLM` torch export →
    `DecoderModel` params. Weights transposed ([out,in] → [in,out])."""
    prefix = "model." if any(k.startswith("model.") for k in state) else ""
    params: dict = {}

    def arr(name):
        return np.asarray(state[prefix + name])

    _set(params, ("embed_tokens", "embedding"),
         arr("embed_tokens.weight"))
    layer_ids = sorted({
        int(m.group(1))
        for k in state
        if (m := re.search(r"layers\.(\d+)\.", k))
    })
    for i in layer_ids:
        base = f"layers.{i}."
        lname = f"layer_{i}"
        for src, dst in (
            ("self_attn.q_proj", ("attention", "q_proj")),
            ("self_attn.k_proj", ("attention", "k_proj")),
            ("self_attn.v_proj", ("attention", "v_proj")),
            ("self_attn.o_proj", ("attention", "o_proj")),
            ("mlp.gate_proj", ("gate_proj",)),
            ("mlp.up_proj", ("up_proj",)),
            ("mlp.down_proj", ("down_proj",)),
        ):
            _set(params, (lname, *dst, "kernel"),
                 arr(base + src + ".weight").T)
        _set(params, (lname, "input_norm", "scale"),
             arr(base + "input_layernorm.weight"))
        _set(params, (lname, "post_attention_norm", "scale"),
             arr(base + "post_attention_layernorm.weight"))
    _set(params, ("final_norm", "scale"), arr("norm.weight"))
    if "lm_head.weight" in state:
        _set(params, ("lm_head", "kernel"),
             np.asarray(state["lm_head.weight"]).T)
    return params


def convert_cross_encoder_state_dict(state: dict) -> dict:
    """Sequence-classification export (backbone + scalar classifier)."""
    prefix = "roberta." if any(k.startswith("roberta.") for k in state) else ""
    params = {"encoder": convert_xlmr_state_dict(state, prefix)}
    if "classifier.dense.weight" in state:  # RoBERTa-style two-layer head
        params["head_dense"] = {
            "kernel": np.asarray(state["classifier.dense.weight"]).T,
            "bias": np.asarray(state["classifier.dense.bias"]),
        }
        params["classifier"] = {
            "kernel": np.asarray(state["classifier.out_proj.weight"]).T,
            "bias": np.asarray(state["classifier.out_proj.bias"]),
        }
    elif "classifier.weight" in state:  # bare scalar head
        params["classifier"] = {
            "kernel": np.asarray(state["classifier.weight"]).T,
            "bias": np.asarray(state["classifier.bias"]),
        }
    return params


def convert_clip_vision_state_dict(state: dict) -> dict:
    """HF `CLIPVisionModel` torch export → `ViTModel` params.

    Layout notes: the stride-P patch conv [H, 3, P, P] becomes the
    explicit patch matmul kernel [3·P², H] (channel-major per-patch
    flatten — exactly the order ViTModel packs pixels); Dense weights
    transpose [out, in] → [in, out]; HF's `pre_layrnorm` (sic) maps to
    `pre_layernorm`.
    """
    prefix = "vision_model." if any(
        k.startswith("vision_model.") for k in state) else ""
    params: dict = {}

    def arr(name):
        return np.asarray(state[prefix + name])

    conv = arr("embeddings.patch_embedding.weight")  # [H, 3, P, P]
    params["patch_kernel"] = conv.reshape(conv.shape[0], -1).T
    params["class_embedding"] = arr("embeddings.class_embedding")
    params["position_embedding"] = arr(
        "embeddings.position_embedding.weight")
    for src, dst in (("pre_layrnorm", "pre_layernorm"),
                     ("post_layernorm", "post_layernorm")):
        params[dst] = {"scale": arr(src + ".weight"),
                       "bias": arr(src + ".bias")}
    layer_ids = sorted({
        int(m.group(1))
        for k in state
        if (m := re.search(r"encoder\.layers\.(\d+)\.", k))
    })
    for i in layer_ids:
        base = f"encoder.layers.{i}."
        lp: dict = {"attention": {}}
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lp["attention"][name] = {
                "kernel": arr(base + f"self_attn.{name}.weight").T,
                "bias": arr(base + f"self_attn.{name}.bias"),
            }
        for name in ("layer_norm1", "layer_norm2"):
            lp[name] = {"scale": arr(base + name + ".weight"),
                        "bias": arr(base + name + ".bias")}
        for name in ("fc1", "fc2"):
            lp[name] = {
                "kernel": arr(base + f"mlp.{name}.weight").T,
                "bias": arr(base + f"mlp.{name}.bias"),
            }
        params[f"layer_{i}"] = lp
    return params


def convert_llava_state_dict(state: dict) -> dict:
    """HF `LlavaForConditionalGeneration` torch export → the three
    param trees of the TPU multimodal stack: `{"vision": ViTModel,
    "projector": LlavaProjector, "decoder": DecoderModel}` (see
    models/llava.py)."""
    vision = {
        k[len("vision_tower."):]: v
        for k, v in state.items() if k.startswith("vision_tower.")
    }
    decoder = {
        k[len("language_model."):]: v
        for k, v in state.items() if k.startswith("language_model.")
    }
    if not decoder:  # transformers >= 4.52 flattened layout:
        # model.language_model.* + TOP-LEVEL lm_head.weight
        decoder = {
            k[len("model.language_model."):]: v
            for k, v in state.items()
            if k.startswith("model.language_model.")
        }
        if "lm_head.weight" in state:
            decoder["lm_head.weight"] = state["lm_head.weight"]
        vision = vision or {
            k[len("model.vision_tower."):]: v
            for k, v in state.items()
            if k.startswith("model.vision_tower.")
        }
    proj_prefix = "multi_modal_projector." if any(
        k.startswith("multi_modal_projector.") for k in state) \
        else "model.multi_modal_projector."
    projector = {
        "linear_1": {
            "kernel": np.asarray(
                state[proj_prefix + "linear_1.weight"]).T,
            "bias": np.asarray(state[proj_prefix + "linear_1.bias"]),
        },
        "linear_2": {
            "kernel": np.asarray(
                state[proj_prefix + "linear_2.weight"]).T,
            "bias": np.asarray(state[proj_prefix + "linear_2.bias"]),
        },
    }
    # convert_llama_state_dict normalizes the prefix itself (it uses
    # "model." only when present), so bare stripped keys pass through
    return {
        "vision": convert_clip_vision_state_dict(vision),
        "projector": projector,
        "decoder": convert_llama_state_dict(decoder),
    }
