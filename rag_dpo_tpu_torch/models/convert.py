"""Parameter trees of the JAX package ↔ the port's modules.

`load_params_npz` reads the npz format both packages share ('/'-joined Flax
paths, as written by `scripts/convert_weights.py` and the training recipe)
and `save_params_npz` writes it; `load_flax_params` copies a Flax tree
(numpy leaves) into a module, and `state_dict_to_flax` is its inverse:

* Dense `kernel [in, out]` → Linear `weight [out, in]`;
* LayerNorm `scale` → `weight`; Embed `embedding` → `weight`;
* scope names map to submodule names one to one
  (`encoder/layer_0/attention/query` → `encoder.layer_0.attention.query`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .encoder import LayerNorm


def flatten_params(tree: dict, prefix: str = "") -> dict:
    """Nested param tree → flat {'a/b/c': ndarray} (npz-serializable)."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.update(flatten_params(value, path))
        else:
            out[path] = np.asarray(value)
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


def flax_to_state_dict(tree: dict) -> dict[str, np.ndarray]:
    """Flax tree ({'params': …} or bare) → torch state-dict names/layouts."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, value in flatten_params(tree).items():
        *scope, leaf = path.split("/")
        value = np.array(value, np.float32)  # a writable copy
        if leaf == "kernel":
            leaf, value = "weight", value.T
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        out[".".join([*scope, leaf])] = value
    return out


def state_dict_to_flax(module: nn.Module) -> dict:
    """A module's parameters → the bare Flax tree of the JAX model (numpy
    f32 leaves): the inverse of `flax_to_state_dict`, which needs the
    module to tell a LayerNorm weight (`scale`) and an Embedding weight
    (`embedding`) from a Linear weight (`kernel`, transposed)."""
    tree: dict = {}
    for scope, sub in module.named_modules():
        if isinstance(sub, nn.Linear):
            leaves = {"kernel": sub.weight.T, "bias": sub.bias}
        elif isinstance(sub, LayerNorm):
            leaves = {"scale": sub.weight, "bias": sub.bias}
        elif isinstance(sub, nn.Embedding):
            leaves = {"embedding": sub.weight}
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
            dst.copy_(torch.from_numpy(np.ascontiguousarray(value)))
    return module
