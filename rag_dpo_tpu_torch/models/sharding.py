"""Parameter sharding rules for tensor parallelism (Megatron layout).

Port of `rag_dpo_tpu/models/sharding.py`, with JAX's path rules: attention
Q/K/V and the MLP's up-projections shard their OUTPUT features (`_COL`), the
attention output and the MLP's down-projection their INPUT features
(`_ROW`), so each block pair needs one all-reduce over the mesh's `model`
axis. Anything unmatched is replicated; that includes the int8 `kernel_q` /
`scale` leaves, which JAX's rule (it matches `kernel` and `bias` only) also
replicates, so TP over the int8 decoder computes every projection whole on
every rank, as JAX's does.

There is no global array here: `shard_params` cuts THIS rank's slices out of
a full Flax tree (numpy leaves, or torch tensors, which stay on their
device: `models.decoder.decoder_flax_tree` of a loaded model) and tags the
tree with the mesh, and the
decoder built from it (`TextGenerator(cfg, params=shard_params(...))`)
holds only those slices and all-reduces after each `_ROW` product. The
kernels see plain tensors (no DTensor): the int8 and flash wrappers take
raw pointers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..parallel.mesh import AXIS_MODEL, axis_index, axis_size

# encoder names + decoder names (q/k/v/gate/up shard output features;
# o_proj/down_proj shard input features → one all-reduce per block pair)
_COL = ("query", "key", "value", "intermediate",
        "q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW = ("output", "mlp_output", "o_proj", "down_proj")


def param_spec(path: tuple) -> tuple:
    """The partition spec of the leaf at `path` (its dict keys): one entry
    per array axis, `"model"` where that axis splits over the mesh's model
    axis; () is replicated (JAX's `P()`)."""
    names = [str(getattr(p, "key", p)) for p in path]
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    if parent in _COL:
        if leaf == "kernel":
            return (None, AXIS_MODEL)
        if leaf == "bias":
            return (AXIS_MODEL,)
    if parent in _ROW and leaf == "kernel":
        return (AXIS_MODEL, None)
    return ()


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the model axis: the group the `_ROW` products
    all-reduce over, its size, and this rank's coordinate."""
    group: object
    size: int
    rank: int

    @classmethod
    def of(cls, mesh) -> "TensorParallel":
        return cls(mesh.get_group(AXIS_MODEL), axis_size(mesh, AXIS_MODEL),
                   axis_index(mesh, AXIS_MODEL))


class ShardedParams(dict):
    """A Flax tree of this rank's TP slices, with the mesh it was cut for
    (`mesh`) and this rank's place on its model axis (`tp`)."""

    def __init__(self, tree: dict, mesh):
        super().__init__(tree)
        self.mesh = mesh
        self.tp = TensorParallel.of(mesh)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def _slice(x, spec: tuple, tp: TensorParallel):
    """This rank's block of `x` (numpy, or a torch tensor kept on its
    device) along every axis the spec splits."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    for axis, name in enumerate(spec):
        if name != AXIS_MODEL:
            continue
        n = x.shape[axis]
        if n % tp.size:
            raise ValueError(f"axis {axis} of size {n} does not split over "
                             f"model={tp.size}")
        per = n // tp.size
        if isinstance(x, torch.Tensor):
            x = x.narrow(axis, tp.rank * per, per)
        else:
            x = np.take(x, np.arange(tp.rank * per, (tp.rank + 1) * per),
                        axis=axis)
    return x


def shard_params(params, mesh) -> ShardedParams:
    """This rank's slices of a Flax param tree under the TP rules."""
    tp = TensorParallel.of(mesh)
    tree = _map_with_path(lambda path, leaf: _slice(
        leaf, param_spec(path), tp), dict(params))
    return ShardedParams(tree, mesh)


def param_shardings(params, mesh) -> dict:
    """The spec of every leaf (`param_spec`), as JAX's NamedSharding tree
    names one; `mesh` is accepted for JAX's signature."""
    del mesh
    return _map_with_path(lambda path, _: param_spec(path), dict(params))
